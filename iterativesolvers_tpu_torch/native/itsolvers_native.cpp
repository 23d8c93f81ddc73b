// Native host-side runtime of iterativesolvers_tpu_torch (the PyTorch /
// CUDA port's own copy of the JAX package's native layer, the same code).
//
// The reference is pure Julia, but its host-side preprocessing —
// sparse-format conversion (SparseMatrixCSC construction), the
// DiagonalIndices scan (src/stationary_sparse.jl:6-28), and the
// MatrixMarket loaders used by the benchmarks (benchmark/matrixmarket.jl)
// — all run compiled.  The port's equivalents live here: construction-side
// kernels that feed device buffers, exposed through ctypes.
//
// Everything operates on caller-allocated flat arrays (int32/int64/double)
// so the Python wrapper can hand in numpy buffers directly.
//
// Build: native/__init__.py (g++ -O3 -march=native -shared -fPIC, at first
// use, into iterativesolvers_tpu_torch/_build/).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// COO -> CSR (sorted rows, columns sorted within each row, duplicates summed)
// Two-phase: call with csr_* = nullptr to get the deduped nnz, then again
// with buffers of that size.
// ---------------------------------------------------------------------------
int64_t coo_to_csr(
    const int64_t* rows, const int64_t* cols, const double* vals, int64_t nnz,
    int64_t n_rows,
    int64_t* csr_indptr,   // (n_rows + 1) or nullptr
    int32_t* csr_indices,  // (nnz_out,) or nullptr
    double* csr_data)      // (nnz_out,) or nullptr
{
    // counting sort by row, then sort each row's (col, val) pairs
    std::vector<int64_t> count(n_rows + 1, 0);
    for (int64_t i = 0; i < nnz; ++i) count[rows[i] + 1]++;
    for (int64_t r = 0; r < n_rows; ++r) count[r + 1] += count[r];

    std::vector<int64_t> perm(nnz);
    {
        std::vector<int64_t> next(count.begin(), count.end() - 1);
        for (int64_t i = 0; i < nnz; ++i) perm[next[rows[i]]++] = i;
    }

    // per-row sort by column + dedup (sum duplicates)
    std::vector<std::pair<int64_t, double>> buf;
    int64_t out = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t lo = count[r], hi = count[r + 1];
        buf.clear();
        buf.reserve(hi - lo);
        for (int64_t p = lo; p < hi; ++p) {
            int64_t i = perm[p];
            buf.emplace_back(cols[i], vals[i]);
        }
        std::sort(buf.begin(), buf.end(),
                  [](const auto& a, const auto& b) { return a.first < b.first; });
        if (csr_indptr) csr_indptr[r] = out;
        for (size_t i = 0; i < buf.size();) {
            int64_t c = buf[i].first;
            double v = 0.0;
            while (i < buf.size() && buf[i].first == c) v += buf[i++].second;
            if (csr_indices) {
                csr_indices[out] = (int32_t)c;
                csr_data[out] = v;
            }
            ++out;
        }
    }
    if (csr_indptr) csr_indptr[n_rows] = out;
    return out;  // deduped nnz
}

// ---------------------------------------------------------------------------
// Level scheduling for a strict-triangular dependency DAG (the construction
// pass behind ops/triangular.py).  level[r] = 1 + max(level[deps]); rows
// are visited in dependency order (ascending for lower, descending for
// upper).  O(nnz).  Returns the number of levels.
// ---------------------------------------------------------------------------
int64_t level_schedule(
    const int64_t* indptr, const int32_t* indices, int64_t n, int32_t lower,
    int64_t* level /* out (n,) */)
{
    int64_t nlev = 0;
    if (lower) {
        for (int64_t r = 0; r < n; ++r) {
            int64_t lv = 0;
            for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
                int64_t d = level[indices[p]] + 1;
                lv = d > lv ? d : lv;
            }
            level[r] = lv;
            nlev = lv + 1 > nlev ? lv + 1 : nlev;
        }
    } else {
        for (int64_t r = n - 1; r >= 0; --r) {
            int64_t lv = 0;
            for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
                int64_t d = level[indices[p]] + 1;
                lv = d > lv ? d : lv;
            }
            level[r] = lv;
            nlev = lv + 1 > nlev ? lv + 1 : nlev;
        }
    }
    return nlev == 0 && n > 0 ? 1 : nlev;
}

// ---------------------------------------------------------------------------
// CSR -> ELL padding (row-major (n, width) data/cols, zero padding)
// ---------------------------------------------------------------------------
void csr_to_ell(
    const int64_t* indptr, const int32_t* indices, const double* data,
    int64_t n, int64_t width,
    int32_t* ell_cols, double* ell_data)
{
    for (int64_t r = 0; r < n; ++r) {
        int64_t lo = indptr[r], hi = indptr[r + 1];
        int64_t w = std::min(hi - lo, width);
        for (int64_t i = 0; i < w; ++i) {
            ell_cols[r * width + i] = indices[lo + i];
            ell_data[r * width + i] = data[lo + i];
        }
        for (int64_t i = w; i < width; ++i) {
            ell_cols[r * width + i] = 0;
            ell_data[r * width + i] = 0.0;
        }
    }
}

// ---------------------------------------------------------------------------
// MatrixMarket reader (coordinate real/integer/pattern, general/symmetric/
// skew-symmetric).  Two-phase like coo_to_csr:
//   phase 1 (rows == nullptr): returns entry count after symmetry expansion,
//            writes shape into shape_out[0..1]
//   phase 2: fills rows/cols (0-based) and vals.
// Returns -1 on parse error, -2 on unsupported format (complex).
// ---------------------------------------------------------------------------
int64_t mm_read(
    const char* path,
    int64_t* shape_out,  // (2,)
    int64_t* rows, int64_t* cols, double* vals)
{
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char line[1024];
    if (!fgets(line, sizeof line, f)) { fclose(f); return -1; }
    char banner[64], object[64], format[64], field[64], symmetry[64];
    if (sscanf(line, "%63s %63s %63s %63s %63s",
               banner, object, format, field, symmetry) != 5) {
        fclose(f); return -1;
    }
    bool pattern = strcmp(field, "pattern") == 0;
    bool complex_ = strcmp(field, "complex") == 0;
    bool symmetric = strcmp(symmetry, "symmetric") == 0;
    bool skew = strcmp(symmetry, "skew-symmetric") == 0;
    if (strcmp(format, "coordinate") != 0 || complex_) { fclose(f); return -2; }

    // skip comments
    long pos;
    do {
        pos = ftell(f);
        if (!fgets(line, sizeof line, f)) { fclose(f); return -1; }
    } while (line[0] == '%');
    fseek(f, pos, SEEK_SET);

    int64_t m, n, nnz;
    if (fscanf(f, "%ld %ld %ld", &m, &n, &nnz) != 3) { fclose(f); return -1; }
    shape_out[0] = m;
    shape_out[1] = n;

    int64_t out = 0;
    for (int64_t i = 0; i < nnz; ++i) {
        int64_t r, c;
        double v = 1.0;
        if (pattern) {
            if (fscanf(f, "%ld %ld", &r, &c) != 2) { fclose(f); return -1; }
        } else {
            if (fscanf(f, "%ld %ld %lf", &r, &c, &v) != 3) { fclose(f); return -1; }
        }
        if (rows) {
            rows[out] = r - 1; cols[out] = c - 1; vals[out] = v;
        }
        ++out;
        if ((symmetric || skew) && r != c) {
            if (rows) {
                rows[out] = c - 1; cols[out] = r - 1;
                vals[out] = skew ? -v : v;
            }
            ++out;
        }
    }
    fclose(f);
    return out;
}

// ---------------------------------------------------------------------------
// Diagonal extraction (~ DiagonalIndices, src/stationary_sparse.jl:6-28):
// writes diag values; returns index of first missing/zero diagonal entry,
// or -1 if all present and nonzero.
// ---------------------------------------------------------------------------
int64_t extract_diagonal(
    const int64_t* indptr, const int32_t* indices, const double* data,
    int64_t n, double* diag)
{
    int64_t bad = -1;
    for (int64_t r = 0; r < n; ++r) {
        double v = 0.0;
        bool found = false;
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
            if (indices[p] == r) { v = data[p]; found = true; break; }
        }
        diag[r] = v;
        if ((!found || v == 0.0) && bad < 0) bad = r;
    }
    return bad;
}

// ---------------------------------------------------------------------------
// ILU(0): incomplete LU with zero fill on the CSR pattern (IKJ variant).
// Requires sorted column indices and a present diagonal in every row.
// In-place on `data`: strict lower part becomes L (unit diagonal implied),
// diagonal + strict upper become U.  Returns -1 on success, or the row of
// the first zero pivot.
// ---------------------------------------------------------------------------
int64_t ilu0(
    const int64_t* indptr, const int32_t* indices, double* data, int64_t n)
{
    std::vector<int64_t> diag_ptr(n, -1);
    for (int64_t r = 0; r < n; ++r)
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p)
            if (indices[p] == r) { diag_ptr[r] = p; break; }
    for (int64_t r = 0; r < n; ++r)
        if (diag_ptr[r] < 0) return r;  // structurally missing diagonal

    std::vector<int64_t> pos(n, -1);  // column -> position within row i
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            pos[indices[p]] = p;
        for (int64_t p = indptr[i]; p < diag_ptr[i]; ++p) {
            int64_t k = indices[p];
            double piv = data[diag_ptr[k]];
            if (piv == 0.0) return k;
            double lik = data[p] / piv;
            data[p] = lik;
            for (int64_t q = diag_ptr[k] + 1; q < indptr[k + 1]; ++q) {
                int64_t r2 = pos[indices[q]];
                if (r2 >= 0) data[r2] -= lik * data[q];
            }
        }
        if (data[diag_ptr[i]] == 0.0) return i;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            pos[indices[p]] = -1;
    }
    return -1;
}

// ---------------------------------------------------------------------------
// IC(0): incomplete Cholesky with zero fill on the LOWER-triangular CSR
// pattern (row i holds columns <= i, sorted, diagonal last).  In-place on
// `data`: becomes the IC factor L with A ~= L L^T.  Returns -1 on success,
// or the row of the first non-positive pivot (breakdown).
// ---------------------------------------------------------------------------
int64_t ic0(
    const int64_t* indptr, const int32_t* indices, double* data, int64_t n)
{
    std::vector<int64_t> pos(n, -1);
    for (int64_t i = 0; i < n; ++i) {
        int64_t lo = indptr[i], hi = indptr[i + 1];
        if (hi <= lo || indices[hi - 1] != i) return i;  // missing diagonal
        for (int64_t p = lo; p < hi; ++p) pos[indices[p]] = p;
        for (int64_t p = lo; p < hi - 1; ++p) {
            int64_t k = indices[p];
            // L[i,k] = (A[i,k] - sum_{j<k} L[i,j] L[k,j]) / L[k,k]
            double s = data[p];
            for (int64_t q = indptr[k]; q < indptr[k + 1] - 1; ++q) {
                int64_t r2 = pos[indices[q]];
                if (r2 >= 0) s -= data[r2] * data[q];
            }
            data[p] = s / data[indptr[k + 1] - 1];
        }
        double d = data[hi - 1];
        for (int64_t p = lo; p < hi - 1; ++p) d -= data[p] * data[p];
        if (d <= 0.0) { for (int64_t p = lo; p < hi; ++p) pos[indices[p]] = -1; return i; }
        data[hi - 1] = std::sqrt(d);
        for (int64_t p = lo; p < hi; ++p) pos[indices[p]] = -1;
    }
    return -1;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering of a SYMMETRIC sparsity pattern (caller
// symmetrizes nonsymmetric patterns, like greedy_coloring below).  BFS from
// a pseudo-peripheral vertex of each component, visiting neighbors in
// ascending-degree order, then reverse — the classic bandwidth-reducing
// permutation that exposes banded/DIA structure for the DIA SpMV.
// perm_out[k] = old index of the vertex placed at new position k.
// Returns the half-bandwidth of the permuted pattern (max |i - j|).
// ---------------------------------------------------------------------------
int64_t rcm_order(
    const int64_t* indptr, const int32_t* indices, int64_t n,
    int64_t* perm_out /* (n,) */)
{
    std::vector<int64_t> deg(n);
    for (int64_t r = 0; r < n; ++r) deg[r] = indptr[r + 1] - indptr[r];

    std::vector<int8_t> visited(n, 0);
    std::vector<int64_t> order;
    order.reserve(n);
    std::vector<int64_t> frontier, next;

    auto bfs_layers = [&](int64_t start, std::vector<int8_t>& seen,
                          std::vector<int64_t>& last_layer) -> int64_t {
        // BFS returning depth; fills last_layer with the final level
        std::fill(seen.begin(), seen.end(), 0);
        frontier.assign(1, start);
        seen[start] = 1;
        int64_t depth = 0;
        last_layer = frontier;
        while (!frontier.empty()) {
            next.clear();
            for (int64_t u : frontier) {
                for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
                    int64_t v = indices[p];
                    if (v == u || v >= n || seen[v]) continue;
                    seen[v] = 1;
                    next.push_back(v);
                }
            }
            if (next.empty()) break;
            last_layer = next;
            frontier.swap(next);
            ++depth;
        }
        return depth;
    };

    std::vector<int8_t> seen(n, 0);
    std::vector<int64_t> last_layer;

    for (int64_t s = 0; s < n; ++s) {
        if (visited[s]) continue;
        // pseudo-peripheral start: a few rounds of "BFS to the farthest,
        // lowest-degree vertex of the last layer"
        int64_t start = s;
        int64_t depth = bfs_layers(start, seen, last_layer);
        for (int it = 0; it < 4; ++it) {
            int64_t best = last_layer[0];
            for (int64_t v : last_layer)
                if (deg[v] < deg[best]) best = v;
            int64_t d2 = bfs_layers(best, seen, last_layer);
            if (d2 <= depth) { start = best; break; }
            depth = d2;
            start = best;
        }
        // Cuthill-McKee BFS with ascending-degree neighbor order
        std::vector<int64_t> q;
        q.push_back(start);
        visited[start] = 1;
        size_t head = 0;
        while (head < q.size()) {
            int64_t u = q[head++];
            order.push_back(u);
            int64_t lo = indptr[u], hi = indptr[u + 1];
            std::vector<int64_t> nbrs;
            nbrs.reserve(hi - lo);
            for (int64_t p = lo; p < hi; ++p) {
                int64_t v = indices[p];
                if (v == u || v >= n || visited[v]) continue;
                visited[v] = 1;
                nbrs.push_back(v);
            }
            std::sort(nbrs.begin(), nbrs.end(),
                      [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
            for (int64_t v : nbrs) q.push_back(v);
        }
    }
    // reverse (the "R" in RCM)
    std::reverse(order.begin(), order.end());
    for (int64_t k = 0; k < n; ++k) perm_out[k] = order[k];

    // bandwidth of the permuted pattern
    std::vector<int64_t> inv(n);
    for (int64_t k = 0; k < n; ++k) inv[order[k]] = k;
    int64_t bw = 0;
    for (int64_t r = 0; r < n; ++r) {
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
            int64_t j = indices[p];
            if (j >= n) continue;
            int64_t d = inv[r] - inv[j];
            if (d < 0) d = -d;
            if (d > bw) bw = d;
        }
    }
    return bw;
}

// ---------------------------------------------------------------------------
// Greedy graph coloring of the (symmetrized) sparsity pattern — rows with
// the same color share no edge, so a Gauss-Seidel/SOR sweep can update each
// color class fully in parallel (the multicolor alternative to level
// scheduling, SURVEY §7).  Input is full-matrix CSR (diagonal ignored).
// Returns the number of colors.
// ---------------------------------------------------------------------------
int64_t greedy_coloring(
    const int64_t* indptr, const int32_t* indices, int64_t n,
    int64_t* color /* out (n,), caller-zeroed */)
{
    std::vector<int64_t> mark(n, -1);
    int64_t ncolors = 0;
    for (int64_t r = 0; r < n; ++r) {
        // mark neighbor colors (out-edges; for nonsymmetric patterns the
        // caller passes A + A^T structure)
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
            int64_t j = indices[p];
            if (j == r || j >= n) continue;
            if (j < r) mark[color[j]] = r;
        }
        int64_t c = 0;
        while (c < n && mark[c] == r) ++c;
        color[r] = c;
        ncolors = c + 1 > ncolors ? c + 1 : ncolors;
    }
    return ncolors;
}

}  // extern "C"
