// Native host-side numerics for functionalmf_tpu.
//
// The reference framework leans on native code for its host-side hot loops
// (CHOLMOD, pypolyagamma, SharedArray; reference setup.py:51). This
// framework moves the device-side numerics to XLA; this library covers
// the *host-side* inner loops that remain sequential and Python-bound in
// the reference: the pool-adjacent-violators projection (reference
// utils.py:458-492) and the Lawson-Hanson NNLS solver that dominates the
// tensor-NMF warm start (reference utils.py:276-420 calls
// scipy.optimize.nnls per row/column/depth cell).
//
// Exposed via a plain C ABI and loaded with ctypes
// (functionalmf_tpu/utils/native.py); every entry point has a pure-numpy
// fallback so the library is an accelerator, not a dependency.

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Monotone-increasing PAV smoothing of y (length n) into out.
// Linear-time stack algorithm; matches the reference's pav()
// (utils.py:458-492) output exactly.
int fmf_pav(const double* y, double* out, long n) {
    if (n <= 0) return -1;
    std::vector<double> vals(n), wts(n);
    std::vector<long> idx(n);
    long top = 0;
    for (long i = 0; i < n; ++i) {
        vals[top] = y[i];
        wts[top] = 1.0;
        idx[top] = i;
        ++top;
        while (top > 1 && vals[top - 2] > vals[top - 1]) {
            double w = wts[top - 2] + wts[top - 1];
            vals[top - 2] =
                (wts[top - 2] * vals[top - 2] + wts[top - 1] * vals[top - 1]) / w;
            wts[top - 2] = w;
            --top;
        }
    }
    long start = 0;
    for (long b = 0; b < top; ++b) {
        long end = (b + 1 < top) ? idx[b + 1] : n;
        for (long i = start; i < end; ++i) out[i] = vals[b];
        start = end;
    }
    return 0;
}

// Weighted monotone-increasing PAV (weights w, length n).
int fmf_pav_weighted(const double* y, const double* w, double* out, long n) {
    if (n <= 0) return -1;
    std::vector<double> vals(n), wts(n);
    std::vector<long> idx(n);
    long top = 0;
    for (long i = 0; i < n; ++i) {
        vals[top] = y[i];
        wts[top] = w[i];
        idx[top] = i;
        ++top;
        while (top > 1 && vals[top - 2] > vals[top - 1]) {
            double ww = wts[top - 2] + wts[top - 1];
            vals[top - 2] =
                (wts[top - 2] * vals[top - 2] + wts[top - 1] * vals[top - 1]) / ww;
            wts[top - 2] = ww;
            --top;
        }
    }
    long start = 0;
    for (long b = 0; b < top; ++b) {
        long end = (b + 1 < top) ? idx[b + 1] : n;
        for (long i = start; i < end; ++i) out[i] = vals[b];
        start = end;
    }
    return 0;
}

namespace {

// Solve the positive-definite system G x = rhs restricted to the passive
// set P (indices p[0..np)), via Cholesky on the np x np submatrix.
// G is n x n row-major. Returns 0 on success.
int solve_passive(const double* G, const double* rhs, const long* p, long np,
                  long n, double* z) {
    std::vector<double> L(np * np, 0.0);
    std::vector<double> y(np);
    // Cholesky of G[P, P]
    for (long i = 0; i < np; ++i) {
        for (long j = 0; j <= i; ++j) {
            double s = G[p[i] * n + p[j]];
            for (long k = 0; k < j; ++k) s -= L[i * np + k] * L[j * np + k];
            if (i == j) {
                if (s <= 1e-300) return -1;
                L[i * np + i] = std::sqrt(s);
            } else {
                L[i * np + j] = s / L[j * np + j];
            }
        }
    }
    // forward solve L y = rhs[P]
    for (long i = 0; i < np; ++i) {
        double s = rhs[p[i]];
        for (long k = 0; k < i; ++k) s -= L[i * np + k] * y[k];
        y[i] = s / L[i * np + i];
    }
    // backward solve L^T z = y
    for (long i = np - 1; i >= 0; --i) {
        double s = y[i];
        for (long k = i + 1; k < np; ++k) s -= L[k * np + i] * z[k];
        z[i] = s / L[i * np + i];
    }
    return 0;
}

}  // namespace

// Gram-form Lawson-Hanson NNLS: min 1/2 x^T G x - f^T x, x >= 0, with
// G = A^T A and f = A^T b precomputed by the caller. This is the natural
// entry point for masked least squares (G = A^T diag(mask) A assembled by
// one einsum) — the design matrix never materializes. Writes x (length n).
// Returns 0 on success, >0 = iteration limit (x usable), <0 = error.
int fmf_nnls_gram(const double* G, const double* f, long n, double* x) {
    if (n <= 0) return -2;
    std::vector<char> passive(n, 0);
    std::vector<long> p;
    std::vector<double> w(n), z(n);
    for (long a = 0; a < n; ++a) x[a] = 0.0;

    double gmax = 0.0;
    for (long a = 0; a < n; ++a) gmax = std::max(gmax, std::fabs(G[a * n + a]));
    const double tol = 1e-11 * (gmax > 0 ? gmax : 1.0) * n;
    const long max_outer = 3 * n + 30;

    for (long outer = 0; outer < max_outer; ++outer) {
        // w = f - G x
        double wmax = -1.0;
        long jstar = -1;
        for (long a = 0; a < n; ++a) {
            if (passive[a]) continue;
            double s = f[a];
            for (long c = 0; c < n; ++c) s -= G[a * n + c] * x[c];
            w[a] = s;
            if (s > wmax) { wmax = s; jstar = a; }
        }
        if (jstar < 0 || wmax <= tol) return 0;  // KKT satisfied
        passive[jstar] = 1;
        p.push_back(jstar);

        // inner loop: restricted LS with positivity restoration
        for (long inner = 0; inner < max_outer; ++inner) {
            long np = (long)p.size();
            if (solve_passive(G, f, p.data(), np, n, z.data()) != 0)
                return -3;
            bool all_pos = true;
            for (long i = 0; i < np; ++i)
                if (z[i] <= 0) { all_pos = false; break; }
            if (all_pos) {
                for (long a = 0; a < n; ++a) x[a] = 0.0;
                for (long i = 0; i < np; ++i) x[p[i]] = z[i];
                break;
            }
            // step toward z until the first passive variable hits zero
            double alpha = 1e300;
            for (long i = 0; i < np; ++i) {
                if (z[i] <= 0) {
                    double xi = x[p[i]];
                    double d = xi - z[i];
                    if (d > 0) alpha = std::min(alpha, xi / d);
                }
            }
            if (alpha > 1e299) alpha = 0.0;
            for (long i = 0; i < np; ++i)
                x[p[i]] += alpha * (z[i] - x[p[i]]);
            // drop zeroed variables from the passive set
            std::vector<long> keep;
            for (long i = 0; i < np; ++i) {
                if (x[p[i]] > tol) keep.push_back(p[i]);
                else { passive[p[i]] = 0; x[p[i]] = 0.0; }
            }
            p.swap(keep);
            if (p.empty()) break;
        }
    }
    return 1;  // iteration limit
}

// Dense-design Lawson-Hanson NNLS: min ||A x - b||, x >= 0.
// A is m x n row-major. Forms the normal equations then defers to the
// Gram-form solver.
int fmf_nnls(const double* A, long m, long n, const double* b, double* x) {
    if (m <= 0 || n <= 0) return -2;
    std::vector<double> G(n * n, 0.0), f(n, 0.0);
    for (long i = 0; i < m; ++i) {
        const double* Ai = A + i * n;
        for (long a = 0; a < n; ++a) {
            f[a] += Ai[a] * b[i];
            for (long c = a; c < n; ++c) G[a * n + c] += Ai[a] * Ai[c];
        }
    }
    for (long a = 0; a < n; ++a)
        for (long c = 0; c < a; ++c) G[a * n + c] = G[c * n + a];
    return fmf_nnls_gram(G.data(), f.data(), n, x);
}

// Batched Gram-form NNLS: nb independent problems, G nb x n x n and
// F nb x n row-major, X nb x n. This is the tensor-NMF inner solver: the
// masked per-(row) / per-(column, depth) least-squares problems reduce to
// k x k Grams assembled host-side in one einsum, so each solve is O(k^3)
// instead of O(m k^2) with a materialized design.
int fmf_nnls_gram_batch(const double* G, const double* F, long n, long nb,
                        double* X) {
    int rc = 0;
    for (long i = 0; i < nb; ++i) {
        int r = fmf_nnls_gram(G + i * n * n, F + i * n, n, X + i * n);
        if (r < 0) return r;
        rc |= r;
    }
    return rc;
}

// Batched NNLS: nb independent problems sharing the same design A
// (m x n); B is nb x m row-major, X is nb x n.
int fmf_nnls_batch(const double* A, long m, long n, const double* B, long nb,
                   double* X) {
    // shared design => shared Gram; per-problem rhs f = A^T b_i
    if (m <= 0 || n <= 0) return -2;
    std::vector<double> G(n * n, 0.0);
    for (long i = 0; i < m; ++i) {
        const double* Ai = A + i * n;
        for (long a = 0; a < n; ++a)
            for (long c = a; c < n; ++c) G[a * n + c] += Ai[a] * Ai[c];
    }
    for (long a = 0; a < n; ++a)
        for (long c = 0; c < a; ++c) G[a * n + c] = G[c * n + a];
    int rc = 0;
    std::vector<double> f(n);
    for (long i = 0; i < nb; ++i) {
        const double* bi = B + i * m;
        for (long a = 0; a < n; ++a) {
            double s = 0.0;
            for (long r = 0; r < m; ++r) s += A[r * n + a] * bi[r];
            f[a] = s;
        }
        int r = fmf_nnls_gram(G.data(), f.data(), n, X + i * n);
        if (r < 0) return r;
        rc |= r;
    }
    return rc;
}

}  // extern "C"
