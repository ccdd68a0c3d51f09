/* Host setup kernels of the PyTorch port's BoomerAMG setup.
 *
 * A copy of the functions of hypre_tpu/native/kernels.c that
 * hypre_tpu_torch/native/__init__.py binds, with the static helpers
 * they use, so the port builds without the JAX package's tree.  The
 * function bodies are kept byte for byte: the port's setup (CF split,
 * P, coarse operators, DIA fill) stays bitwise equal to the JAX
 * package's, which tests/test_torch_setup.py checks.
 *
 * Built at first use with `cc -O3 -shared -fPIC` into
 * hypre_tpu_torch/_build/ and bound with ctypes.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

/* hypre's exact interpolation-truncation tie order: middle-pivot
 * quicksort, descending by |w|, strict comparison
 * (utilities/hypre_qsort.c hypre_qsort2_abs:367; used by
 * hypre_ParCSRMatrixTruncate par_csr_matrix.c).  Ties keep hypre's
 * partition order, which a stable argsort does NOT reproduce. */
static void qsort2_abs(int64_t *v, double *w, int64_t left, int64_t right)
{
    if (left >= right) return;
    int64_t mid = (left + right) / 2;
    int64_t tv = v[left]; v[left] = v[mid]; v[mid] = tv;
    double tw = w[left]; w[left] = w[mid]; w[mid] = tw;
    int64_t last = left;
    double pa = w[left] < 0 ? -w[left] : w[left];
    for (int64_t i = left + 1; i <= right; ++i) {
        double ai = w[i] < 0 ? -w[i] : w[i];
        if (ai > pa) {
            ++last;
            tv = v[last]; v[last] = v[i]; v[i] = tv;
            tw = w[last]; w[last] = w[i]; w[i] = tw;
        }
    }
    tv = v[left]; v[left] = v[last]; v[last] = tv;
    tw = w[left]; w[left] = w[last]; w[last] = tw;
    qsort2_abs(v, w, left, last - 1);
    qsort2_abs(v, w, last + 1, right);
}

void trunc_keep(const int64_t *indptr, const int64_t *cols,
                const double *vals, int64_t n, int64_t max_elmts,
                uint8_t *keep)
{
    int64_t cap = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t len = indptr[i + 1] - indptr[i];
        if (len > cap) cap = len;
    }
    int64_t *cbuf = (int64_t *)malloc(cap * sizeof(int64_t));
    double *vbuf = (double *)malloc(cap * sizeof(double));
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = indptr[i], e = indptr[i + 1], len = e - s;
        if (len <= max_elmts) {
            for (int64_t j = s; j < e; ++j) keep[j] = 1;
            continue;
        }
        for (int64_t j = 0; j < len; ++j) { cbuf[j] = cols[s + j]; vbuf[j] = vals[s + j]; }
        qsort2_abs(cbuf, vbuf, 0, len - 1);
        for (int64_t j = s; j < e; ++j) keep[j] = 0;
        for (int64_t k = 0; k < max_elmts; ++k) {
            int64_t c = cbuf[k];
            for (int64_t j = s; j < e; ++j) {
                if (cols[j] == c && !keep[j]) { keep[j] = 1; break; }
            }
        }
    }
    free(cbuf);
    free(vbuf);
}

/* PMIS iterated independent set (par_coarsen.c:2031-2738 serial
 * semantics, staged exactly like the vectorized python in
 * solvers/amg/coarsen.py — same CF output bit for bit).
 * measure: |S^T col| + LCG rand on entry (zeroed for settled points by
 * the CALLER for cf_init != 0 entries); cf: pre-initialized (0
 * unassigned, +-1 preset, -3 isolated).  first_round_is = run the IS
 * selection on round 0 (PMIS yes, HMIS continuation no). */
void pmis_loop(const int64_t *S_indptr, const int64_t *S_indices,
               int64_t n, double *measure, int64_t *cf, int first_round_is)
{
    /* ST via counting transpose (indices stay sorted per row) */
    int64_t nnz = S_indptr[n];
    int64_t *STp = (int64_t *)calloc(n + 2, sizeof(int64_t));
    int64_t *STi = (int64_t *)malloc((nnz > 0 ? nnz : 1) * sizeof(int64_t));
    for (int64_t p = 0; p < nnz; ++p) STp[S_indices[p] + 2]++;
    for (int64_t i = 2; i <= n + 1; ++i) STp[i] += STp[i - 1];
    for (int64_t i = 0; i < n; ++i)
        for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p)
            STi[STp[S_indices[p] + 1]++] = i;

    unsigned char *in_graph = (unsigned char *)malloc(n);
    unsigned char *newly = (unsigned char *)malloc(n);
    int64_t remaining = 0;
    for (int64_t i = 0; i < n; ++i) {
        in_graph[i] = (cf[i] == 0);
        remaining += in_graph[i];
    }

    int it = 0;
    while (remaining > 0) {
        if (first_round_is || it > 0) {
            /* IS selection: candidate iff measure > 1; removed iff an
             * adjacent (S u S^T) candidate has strictly larger measure.
             * Stage into `newly` (reads are all pre-update state). */
            for (int64_t i = 0; i < n; ++i) {
                newly[i] = 0;
                if (!in_graph[i] || !(measure[i] > 1.0)) continue;
                double m = measure[i], maxadj = 0.0;
                for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
                    int64_t j = S_indices[p];
                    if (in_graph[j] && measure[j] > 1.0 && measure[j] > maxadj)
                        maxadj = measure[j];
                }
                for (int64_t p = STp[i]; p < STp[i + 1]; ++p) {
                    int64_t j = STi[p];
                    if (in_graph[j] && measure[j] > 1.0 && measure[j] > maxadj)
                        maxadj = measure[j];
                }
                if (!(maxadj > m)) newly[i] = 1;
            }
            for (int64_t i = 0; i < n; ++i)
                if (newly[i]) cf[i] = 1;
        }
        ++it;

        /* C/F assignment (reads tentative IS markers cf > 0) */
        for (int64_t i = 0; i < n; ++i) {
            newly[i] = 0;
            if (!in_graph[i]) continue;
            if (measure[i] < 1.0) { newly[i] = 1; continue; }
            if (cf[i] > 0) continue;
            for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p)
                if (cf[S_indices[p]] > 0) { newly[i] = 1; break; }
        }
        for (int64_t i = 0; i < n; ++i) {
            if (!in_graph[i]) continue;
            if (cf[i] > 0) cf[i] = 1;
            if (newly[i]) cf[i] = -1;
            if (cf[i] != 0) {
                measure[i] = 0.0;
                in_graph[i] = 0;
                --remaining;
            }
        }
        if (it > 500) break;
    }
    free(STp); free(STi); free(in_graph); free(newly);
}

/* Modified classical interpolation (par_interp.c:631-906 semantics,
 * matching solvers/amg/interp.py classical_interp).  diag = A
 * diagonal.  cmap[i] = coarse index of fine C point i.  Emits CSR of P
 * (F rows: strong-C cols with nonzero weight; C rows: identity).
 * Caller allocates P_indices/P_data with cap >= nnz(S) + n.
 * Returns nnz(P). */
int64_t classical_interp_fill(
    const int64_t *A_indptr, const int64_t *A_indices, const double *A_data,
    const double *diag, const int64_t *S_indptr, const int64_t *S_indices,
    const int64_t *cf, const int64_t *cmap, int64_t n,
    int64_t *P_indptr, int64_t *P_indices, double *P_data)
{
    int64_t *cmark = (int64_t *)malloc(n * sizeof(int64_t));
    unsigned char *smark = (unsigned char *)calloc(n, 1);
    int64_t *clist = (int64_t *)malloc(n * sizeof(int64_t));
    double *w = (double *)malloc(n * sizeof(double));
    for (int64_t i = 0; i < n; ++i) cmark[i] = -1;

    int64_t nnz = 0;
    P_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (cf[i] > 0) {
            P_indices[nnz] = cmap[i];
            P_data[nnz++] = 1.0;
            P_indptr[i + 1] = nnz;
            continue;
        }
        int64_t nc = 0;
        for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
            int64_t j = S_indices[p];
            smark[j] = 1;
            if (cf[j] > 0) { cmark[j] = nc; clist[nc] = j; w[nc++] = 0.0; }
        }
        double d = 0.0;
        for (int64_t p = A_indptr[i]; p < A_indptr[i + 1]; ++p) {
            int64_t j = A_indices[p];
            double a = A_data[p];
            if (j == i) { d += a; continue; }
            if (smark[j] && cf[j] > 0) { w[cmark[j]] += a; continue; }
            if (smark[j] && cf[j] == -1) {
                double sgn = diag[j] < 0 ? -1.0 : 1.0;
                double sum_k = 0.0;
                for (int64_t q = A_indptr[j]; q < A_indptr[j + 1]; ++q) {
                    int64_t m = A_indices[q];
                    if (cmark[m] >= 0 && sgn * A_data[q] < 0)
                        sum_k += A_data[q];
                }
                if (sum_k != 0.0) {
                    double scale = a / sum_k;
                    for (int64_t q = A_indptr[j]; q < A_indptr[j + 1]; ++q) {
                        int64_t m = A_indices[q];
                        if (cmark[m] >= 0 && sgn * A_data[q] < 0)
                            w[cmark[m]] += scale * A_data[q];
                    }
                } else {
                    d += a;
                }
                continue;
            }
            d += a; /* weak (incl. SF and strong-SF) */
        }
        for (int64_t c = 0; c < nc; ++c) {
            if (w[c] != 0.0) {
                P_indices[nnz] = cmap[clist[c]];
                P_data[nnz++] = -w[c] / d;
            }
        }
        /* clear markers */
        for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
            smark[S_indices[p]] = 0;
            cmark[S_indices[p]] = -1;
        }
        P_indptr[i + 1] = nnz;
    }
    free(cmark); free(smark); free(clist); free(w);
    return nnz;
}

/* Extended+i interpolation fill (par_lr_interp.c:1041-1860, serial).
 * Inputs: CSR of A (sorted), CSR pattern of S (sorted), cf markers
 * (>=0 C, -1 F, -3 SF).  Outputs to preallocated COO arrays; returns
 * nnz(P) (caller re-runs with a larger cap if exceeded). */
int64_t ext_pi_interp(const int64_t *A_indptr, const int64_t *A_indices,
                      const double *A_data, const int64_t *S_indptr,
                      const int64_t *S_indices, const int64_t *cf,
                      int64_t n, int64_t *out_rows, int64_t *out_cols,
                      double *out_vals, int64_t cap)
{
    int64_t *cmap = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t nc = 0;
    for (int64_t i = 0; i < n; ++i) cmap[i] = (cf[i] >= 0) ? nc++ : -1;

    /* marker[x]: -1 untouched; >=0 slot in (cols,w); -9 strong-F of row */
    int64_t *marker = (int64_t *)malloc(n * sizeof(int64_t));
    for (int64_t x = 0; x < n; ++x) marker[x] = -1;
    int64_t *cols = (int64_t *)malloc(n * sizeof(int64_t));
    double *w = (double *)malloc(n * sizeof(double));
    int64_t *ftouch = (int64_t *)malloc(n * sizeof(int64_t));

    int64_t nnz = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (cf[i] >= 0) {
            if (nnz < cap) {
                out_rows[nnz] = i; out_cols[nnz] = cmap[i]; out_vals[nnz] = 1.0;
            }
            ++nnz;
            continue;
        }
        if (cf[i] == -3) continue;

        int64_t nw = 0, nf = 0;
        /* pass 1: build C_i^ext (strong C of i, plus strong C of each
           strong-F neighbor), interleaved in row order like the
           reference count/fill loops */
        for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
            int64_t j = S_indices[p];
            if (cf[j] >= 0) {
                if (marker[j] == -1) { marker[j] = nw; cols[nw] = j; w[nw++] = 0.0; }
            } else if (cf[j] == -1) {
                if (marker[j] == -1) { marker[j] = -9; ftouch[nf++] = j; }
                for (int64_t q = S_indptr[j]; q < S_indptr[j + 1]; ++q) {
                    int64_t k = S_indices[q];
                    if (cf[k] >= 0 && marker[k] == -1) {
                        marker[k] = nw; cols[nw] = k; w[nw++] = 0.0;
                    }
                }
            }
        }
        double diag = 0.0;
        /* pass 2: accumulate over A row i (par_lr_interp.c:1663-1731) */
        for (int64_t p = A_indptr[i]; p < A_indptr[i + 1]; ++p) {
            int64_t j = A_indices[p];
            double a = A_data[p];
            if (j == i) { diag += a; continue; }
            if (marker[j] >= 0) {
                w[marker[j]] += a;
            } else if (marker[j] == -9) {
                double akk = 0.0;
                for (int64_t q = A_indptr[j]; q < A_indptr[j + 1]; ++q)
                    if (A_indices[q] == j) { akk = A_data[q]; break; }
                double sgn = (akk < 0) ? -1.0 : 1.0;
                double sum = 0.0;
                for (int64_t q = A_indptr[j]; q < A_indptr[j + 1]; ++q) {
                    int64_t m = A_indices[q];
                    if (m == j) continue;
                    if (sgn * A_data[q] < 0 && (marker[m] >= 0 || m == i))
                        sum += A_data[q];
                }
                if (sum != 0.0) {
                    double dist = a / sum;
                    for (int64_t q = A_indptr[j]; q < A_indptr[j + 1]; ++q) {
                        int64_t m = A_indices[q];
                        if (m == j) continue;
                        if (sgn * A_data[q] < 0) {
                            if (marker[m] >= 0) w[marker[m]] += dist * A_data[q];
                            if (m == i) diag += dist * A_data[q];
                        }
                    }
                } else {
                    diag += a;
                }
            } else if (cf[j] != -3) {
                diag += a;
            }
        }
        if (diag != 0.0) {
            for (int64_t k = 0; k < nw; ++k) {
                double v = -w[k] / diag;
                if (v != 0.0) {
                    if (nnz < cap) {
                        out_rows[nnz] = i;
                        out_cols[nnz] = cmap[cols[k]];
                        out_vals[nnz] = v;
                    }
                    ++nnz;
                }
            }
        }
        for (int64_t k = 0; k < nw; ++k) marker[cols[k]] = -1;
        for (int64_t k = 0; k < nf; ++k) marker[ftouch[k]] = -1;
    }
    free(cmap); free(marker); free(cols); free(w); free(ftouch);
    return nnz;
}

/* int32-CSR + direct-target-dtype fill variants: scipy's native index
 * currency in (no int64 upconversion copies of nnz-sized index
 * arrays), the frozen buffer's dtype out (no post-fill astype pass —
 * at 96^3 the f32->bf16 astype alone re-streams the whole hierarchy).
 * bf16 conversion is double->float (C cast, RNE) then float->bf16 RNE
 * — bitwise identical to numpy astype(float32).astype(ml_dtypes
 * .bfloat16), so frozen hierarchies are unchanged. */
static inline uint16_t f32_to_bf16(float f)
{
    uint32_t x;
    memcpy(&x, &f, 4);
    if ((x & 0x7fffffffu) > 0x7f800000u)        /* NaN: quiet, keep sign */
        return (uint16_t)((x >> 16) | 0x0040u);
    uint32_t round = ((x >> 16) & 1u) + 0x7fffu;
    return (uint16_t)((x + round) >> 16);
}

int64_t dia_offsets_i32(const int32_t *Ap, const int32_t *Ai, int64_t n,
                        int64_t m, unsigned char *mark, int64_t *uniq)
{
    (void)m;
    for (int64_t i = 0; i < n; ++i)
        for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p)
            mark[(int64_t)Ai[p] - i + (n - 1)] = 1;
    int64_t cnt = 0;
    int64_t span = n + m - 1;
    for (int64_t o = 0; o < span; ++o)
        if (mark[o]) uniq[cnt++] = o - (n - 1);
    return cnt;
}

#define DIA_FILL_I32_BODY(CONVERT, OTYPE)                                 \
    int64_t *lut = (int64_t *)malloc((n + m - 1) * sizeof(int64_t));      \
    for (int64_t k = 0; k < noff; ++k) lut[uniq[k] + (n - 1)] = k;        \
    for (int64_t i = 0; i < n; ++i)                                       \
        for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p)                       \
            out[lut[(int64_t)Ai[p] - i + (n - 1)] * width + i] =          \
                CONVERT(Ax[p]);                                           \
    free(lut);

void dia_fill_i32_f64(const int32_t *Ap, const int32_t *Ai,
                      const double *Ax, int64_t n, int64_t m,
                      const int64_t *uniq, int64_t noff, int64_t width,
                      double *out)
{
    DIA_FILL_I32_BODY((double), double)
}

void dia_fill_i32_f32(const int32_t *Ap, const int32_t *Ai,
                      const double *Ax, int64_t n, int64_t m,
                      const int64_t *uniq, int64_t noff, int64_t width,
                      float *out)
{
    DIA_FILL_I32_BODY((float), float)
}

#define D2BF16(x) f32_to_bf16((float)(x))
void dia_fill_i32_bf16(const int32_t *Ap, const int32_t *Ai,
                       const double *Ax, int64_t n, int64_t m,
                       const int64_t *uniq, int64_t noff, int64_t width,
                       uint16_t *out)
{
    DIA_FILL_I32_BODY(D2BF16, uint16_t)
}

/* COO (already embedded: off = col - row) variant for
 * build_embedded_dia: offsets+counts in one linear pass pair.  (The
 * coo_dia_fill_* functions beside it in the JAX package's source are
 * not copied: the port fills the diagonal image on the device.) */
int64_t coo_dia_offsets(const int64_t *rows, const int64_t *cols,
                        int64_t nnz, int64_t n, unsigned char *mark,
                        int64_t *uniq, int64_t *cnt)
{
    for (int64_t p = 0; p < nnz; ++p)
        mark[cols[p] - rows[p] + (n - 1)] = 1;
    int64_t noff = 0;
    for (int64_t o = 0; o < 2 * n - 1; ++o)
        if (mark[o]) uniq[noff++] = o - (n - 1);
    int64_t *lut = (int64_t *)malloc((2 * n - 1) * sizeof(int64_t));
    for (int64_t k = 0; k < noff; ++k) { lut[uniq[k] + (n - 1)] = k; cnt[k] = 0; }
    for (int64_t p = 0; p < nnz; ++p)
        ++cnt[lut[cols[p] - rows[p] + (n - 1)]];
    free(lut);
    return noff;
}

/* Embedded-offset enumeration for the lattice relocation planner
 * (ops/dia.py embedded_offsets / embedded_offset_count): given a
 * compressed operator M (COO row/col) and lattice position maps
 * rpos/cpos, enumerate the distinct embedded diagonals
 * off = cpos[col] - rpos[row] and their entry counts in two linear
 * passes, with no nnz-sized temporaries.  i32 variant avoids the
 * int64 conversion copies of scipy's default index dtype. */
#define EMB_OFFSETS_BODY(ITYPE)                                           \
    for (int64_t p = 0; p < nnz; ++p)                                     \
        mark[cpos[mcol[p]] - rpos[mrow[p]] + (n - 1)] = 1;                \
    int64_t noff = 0;                                                     \
    for (int64_t o = 0; o < 2 * n - 1; ++o)                               \
        if (mark[o]) uniq[noff++] = o - (n - 1);                          \
    int64_t *lut = (int64_t *)malloc((2 * n - 1) * sizeof(int64_t));      \
    for (int64_t k = 0; k < noff; ++k) { lut[uniq[k] + (n - 1)] = k; cnt[k] = 0; } \
    for (int64_t p = 0; p < nnz; ++p)                                     \
        ++cnt[lut[cpos[mcol[p]] - rpos[mrow[p]] + (n - 1)]];              \
    free(lut);                                                            \
    return noff;

int64_t embedded_offsets_i32(const int32_t *mrow, const int32_t *mcol,
                             int64_t nnz, const int64_t *rpos,
                             const int64_t *cpos, int64_t n,
                             unsigned char *mark, int64_t *uniq,
                             int64_t *cnt)
{
    EMB_OFFSETS_BODY(int32_t)
}

int64_t embedded_offsets_i64(const int64_t *mrow, const int64_t *mcol,
                             int64_t nnz, const int64_t *rpos,
                             const int64_t *cpos, int64_t n,
                             unsigned char *mark, int64_t *uniq,
                             int64_t *cnt)
{
    EMB_OFFSETS_BODY(int64_t)
}

/* Two-pass, int32-CSR variant of the non-Galerkin filter: operates
 * directly on scipy's native int32 index arrays and fills caller
 * (numpy-)allocated outputs, eliminating the int64 conversion and the
 * malloc->copy round trips of nongalerkin_filter_c (profiled at ~7 s
 * of pure memcpy per 96^3 setup on a 1-core host). */
int64_t nongalerkin_count_i32(const int32_t *Ap, const int32_t *Ai,
                              const double *Ax, int64_t n, double tol,
                              unsigned char *keep2, int64_t *Cp)
{
    double *d = (double *)malloc(n * sizeof(double));
    for (int64_t i = 0; i < n; ++i) {
        double v = 0.0;
        for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p)
            if (Ai[p] == i) { v = Ax[p]; break; }
        v = sqrt(fabs(v));
        d[i] = (v == 0.0) ? 1.0 : v;
    }
    int64_t nnz = Ap[n];
    unsigned char *keep = (unsigned char *)malloc(nnz);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
            int32_t j = Ai[p];
            keep[p] = (j == i) || !(fabs(Ax[p]) < tol * d[i] * d[j]);
        }
    for (int64_t p = 0; p < nnz; ++p) keep2[p] = keep[p];
    for (int64_t i = 0; i < n; ++i)
        for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
            if (keep2[p]) continue;
            int32_t j = Ai[p];
            int64_t lo = Ap[j], hi = Ap[j + 1] - 1, pos = -1;
            while (lo <= hi) {
                int64_t mid = (lo + hi) >> 1;
                if (Ai[mid] == (int32_t)i) { pos = mid; break; }
                if (Ai[mid] < (int32_t)i) lo = mid + 1; else hi = mid - 1;
            }
            if (pos >= 0 && keep[pos]) keep2[p] = 1;
        }
    free(keep);
    free(d);
    Cp[0] = 0;
    int64_t out_nnz = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t cnt = 0;
        int has_diag = 0;
        for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p)
            if (keep2[p]) { ++cnt; if (Ai[p] == i) has_diag = 1; }
        if (!has_diag) ++cnt;
        out_nnz += cnt;
        Cp[i + 1] = out_nnz;
    }
    return out_nnz;
}

void nongalerkin_fill_i32(const int32_t *Ap, const int32_t *Ai,
                          const double *Ax, int64_t n, int lump_strong,
                          const unsigned char *keep2, const int64_t *Cp,
                          int32_t *Ci, double *Cx)
{
    for (int64_t i = 0; i < n; ++i) {
        double dropped = 0.0, wsum = 0.0;
        for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
            if (!keep2[p]) dropped += Ax[p];
            else if (Ai[p] != i) wsum += fabs(Ax[p]);
        }
        int64_t w = Cp[i];
        int wrote_diag = 0;
        double scale = (lump_strong && wsum > 0.0) ? dropped / wsum : 0.0;
        double diag_add = (lump_strong && wsum > 0.0) ? 0.0 : dropped;
        for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
            if (!keep2[p]) continue;
            int32_t j = Ai[p];
            double v = Ax[p];
            if (j == (int32_t)i) { v += diag_add; wrote_diag = 1; }
            else if (scale != 0.0) v += scale * fabs(Ax[p]);
            Ci[w] = j; Cx[w++] = v;
        }
        if (!wrote_diag) {
            int64_t ins = Cp[i];
            while (ins < w && Ci[ins] < (int32_t)i) ++ins;
            for (int64_t q = w; q > ins; --q) { Ci[q] = Ci[q-1]; Cx[q] = Cx[q-1]; }
            Ci[ins] = (int32_t)i; Cx[ins] = diag_add;
        }
    }
}

/* int32-CSR strength variant: runs on scipy's native index arrays and
 * emits int32 S indices, removing the per-level int64 conversion
 * copies (profiled ~2.8 s per 96^3 setup). */
int64_t strength_classical_i32(const int32_t *indptr, const int32_t *indices,
                               const double *data, int64_t n,
                               double theta, double max_row_sum, int sabs,
                               int32_t *S_indptr, int32_t *S_indices)
{
    int64_t nnz = 0;
    S_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        double diag = 0.0, row_scale = 0.0, row_sum = 0.0;
        int64_t p0 = indptr[i], p1 = indptr[i + 1];
        for (int64_t p = p0; p < p1; ++p)
            if (indices[p] == (int32_t)i) { diag = data[p]; break; }
        if (sabs) {
            for (int64_t p = p0; p < p1; ++p) {
                double v = fabs(data[p]);
                row_sum += v;
                if (indices[p] != (int32_t)i && v > row_scale) row_scale = v;
            }
        } else if (diag < 0) {
            for (int64_t p = p0; p < p1; ++p) {
                row_sum += data[p];
                if (indices[p] != (int32_t)i && data[p] > row_scale)
                    row_scale = data[p];
            }
        } else {
            for (int64_t p = p0; p < p1; ++p) {
                row_sum += data[p];
                if (indices[p] != (int32_t)i && data[p] < row_scale)
                    row_scale = data[p];
            }
        }
        int weak_row = 0;
        if (max_row_sum < 1.0) {
            if (sabs)
                weak_row = row_sum < fabs(diag) * (2.0 - max_row_sum);
            else
                weak_row = fabs(row_sum) > fabs(diag) * max_row_sum;
        }
        if (!weak_row) {
            double thresh = theta * row_scale;
            if (sabs) {
                for (int64_t p = p0; p < p1; ++p)
                    if (indices[p] != (int32_t)i && fabs(data[p]) > thresh)
                        S_indices[nnz++] = indices[p];
            } else if (diag < 0) {
                for (int64_t p = p0; p < p1; ++p)
                    if (indices[p] != (int32_t)i && data[p] > thresh)
                        S_indices[nnz++] = indices[p];
            } else {
                for (int64_t p = p0; p < p1; ++p)
                    if (indices[p] != (int32_t)i && data[p] < thresh)
                        S_indices[nnz++] = indices[p];
            }
        }
        S_indptr[i + 1] = (int32_t)nnz;
    }
    return nnz;
}

/* Classical Ruge-Stueben first pass (par_coarsen.c:874 structure):
 * bucket queue keyed by measure = |S^T row| with the standard
 * increment/decrement updates.  cf: 1 = C, -1 = F, -3 = isolated. */
void rs_coarsen(const int64_t *S_indptr, const int64_t *S_indices,
                const int64_t *ST_indptr, const int64_t *ST_indices,
                int64_t n, int64_t *cf)
{
    int64_t *measure = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t *settled = (int64_t *)calloc(n, sizeof(int64_t));

    int64_t max_measure = 0;
    for (int64_t i = 0; i < n; ++i) {
        measure[i] = ST_indptr[i + 1] - ST_indptr[i];
        cf[i] = 0;
        if (measure[i] == 0 && S_indptr[i + 1] == S_indptr[i]) {
            cf[i] = -3; /* isolated */
            settled[i] = 1;
        }
        if (measure[i] > max_measure) max_measure = measure[i];
    }

    /* bucket lists by measure (measures can grow to ~2*max) */
    int64_t nbuckets = 2 * max_measure + n + 2;
    int64_t *head = (int64_t *)malloc(nbuckets * sizeof(int64_t));
    int64_t *next = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t *prev = (int64_t *)malloc(n * sizeof(int64_t));
    for (int64_t b = 0; b < nbuckets; ++b) head[b] = -1;
    for (int64_t i = 0; i < n; ++i) next[i] = prev[i] = -1;

#define BUCKET_INSERT(i)                                                  \
    do {                                                                  \
        int64_t b = measure[i];                                           \
        next[i] = head[b];                                                \
        prev[i] = -1;                                                     \
        if (head[b] >= 0) prev[head[b]] = (i);                            \
        head[b] = (i);                                                    \
    } while (0)

#define BUCKET_REMOVE(i)                                                  \
    do {                                                                  \
        if (prev[i] >= 0) next[prev[i]] = next[i];                        \
        else head[measure[i]] = next[i];                                  \
        if (next[i] >= 0) prev[next[i]] = prev[i];                        \
        next[i] = prev[i] = -1;                                           \
    } while (0)

    for (int64_t i = 0; i < n; ++i)
        if (!settled[i]) BUCKET_INSERT(i);

    int64_t cur_max = max_measure;
    for (;;) {
        while (cur_max > 0 && head[cur_max] < 0) --cur_max;
        if (cur_max <= 0) break;
        int64_t i = head[cur_max];
        BUCKET_REMOVE(i);
        cf[i] = 1;
        settled[i] = 1;
        /* points depending on i become F; their influencers gain measure */
        for (int64_t k = ST_indptr[i]; k < ST_indptr[i + 1]; ++k) {
            int64_t j = ST_indices[k];
            if (settled[j]) continue;
            BUCKET_REMOVE(j);
            cf[j] = -1;
            settled[j] = 1;
            for (int64_t kk = S_indptr[j]; kk < S_indptr[j + 1]; ++kk) {
                int64_t m = S_indices[kk];
                if (settled[m]) continue;
                BUCKET_REMOVE(m);
                measure[m] += 1;
                if (measure[m] >= nbuckets) measure[m] = nbuckets - 1;
                BUCKET_INSERT(m);
                if (measure[m] > cur_max) cur_max = measure[m];
            }
        }
        /* i's influencees lose it as a potential C neighbor */
        for (int64_t k = S_indptr[i]; k < S_indptr[i + 1]; ++k) {
            int64_t j = S_indices[k];
            if (settled[j]) continue;
            BUCKET_REMOVE(j);
            if (measure[j] > 0) measure[j] -= 1;
            BUCKET_INSERT(j);
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (!settled[i]) cf[i] = -1;

    free(measure);
    free(settled);
    free(head);
    free(next);
    free(prev);
}

/* CLJP coarsening (par_coarsen.c:93 hypre_BoomerAMGCoarsen, serial form).
 * S_indices entries are mutated (sign-encoded edge removal, the
 * reference's in-place trick).  measure holds |S^T col| + rand on entry.
 * cf: 0 unassigned -> 1 C / -1 F. */
void cljp_coarsen(const int64_t *S_indptr, int64_t *S_indices, int64_t n,
                  double *measure, int64_t *cf)
{
    const int64_t C_PT = 1, F_PT = -1, SF_PT = -3, COMMON_C = -2;
    int64_t *graph = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t graph_size = n;
    for (int64_t i = 0; i < n; ++i) { graph[i] = i; cf[i] = 0; }

    for (;;) {
        /* F-assignment: measure < 1 and all row edges removed */
        for (int64_t ig = 0; ig < graph_size; ++ig) {
            int64_t i = graph[ig];
            if (cf[i] != C_PT && measure[i] < 1.0) {
                cf[i] = F_PT;
                for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p)
                    if (S_indices[p] > -1) { cf[i] = 0; break; }
            }
            if (cf[i]) {
                measure[i] = 0.0;
                graph[ig] = graph[--graph_size];
                graph[graph_size] = i;
                --ig;
            }
        }
        if (graph_size == 0) break;

        /* independent set: candidates measure > 1, strict loser removal */
        for (int64_t ig = 0; ig < graph_size; ++ig) {
            int64_t i = graph[ig];
            if (measure[i] > 1.0) cf[i] = 1;
        }
        for (int64_t ig = 0; ig < graph_size; ++ig) {
            int64_t i = graph[ig];
            if (measure[i] > 1.0) {
                for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
                    int64_t j = S_indices[p];
                    if (j < 0) j = -j - 1;
                    if (measure[j] > 1.0) {
                        if (measure[i] > measure[j]) cf[j] = 0;
                        else if (measure[j] > measure[i]) cf[i] = 0;
                    }
                }
            }
        }

        /* C assignment + CLJP heuristics (par_coarsen.c:615-800) */
        for (int64_t ig = 0; ig < graph_size; ++ig) {
            int64_t i = graph[ig];
            if (cf[i] > 0) {
                cf[i] = C_PT;
                for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
                    int64_t j = S_indices[p];
                    if (j > -1) {
                        S_indices[p] = -j - 1; /* remove edge */
                        if (!cf[j]) measure[j] -= 1.0;
                    }
                }
            } else {
                /* marked dependencies */
                for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
                    int64_t j = S_indices[p];
                    if (j < 0) j = -j - 1;
                    if (cf[j] > 0) {
                        if (S_indices[p] > -1) S_indices[p] = -S_indices[p] - 1;
                        cf[j] = COMMON_C;
                    } else if (cf[j] == SF_PT) {
                        if (S_indices[p] > -1) S_indices[p] = -S_indices[p] - 1;
                    }
                }
                /* unmarked dependencies: common-C heuristic */
                for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
                    if (S_indices[p] > -1) {
                        int64_t j = S_indices[p];
                        for (int64_t q = S_indptr[j]; q < S_indptr[j + 1]; ++q) {
                            int64_t k = S_indices[q];
                            if (k < 0) k = -k - 1;
                            if (cf[k] == COMMON_C) {
                                S_indices[p] = -S_indices[p] - 1;
                                measure[j] -= 1.0;
                                break;
                            }
                        }
                    }
                }
                /* reset temporary markers */
                for (int64_t p = S_indptr[i]; p < S_indptr[i + 1]; ++p) {
                    int64_t j = S_indices[p];
                    if (j < 0) j = -j - 1;
                    if (cf[j] == COMMON_C) cf[j] = C_PT;
                }
            }
        }
    }
    free(graph);
}

/* Wavefront levels of the lower(upper)-triangular dependency DAG:
 * level[i] = 1 + max(level[j]) over j < i (forward) with A[i,j] != 0. */
void gs_levels(const int64_t *indptr, const int64_t *indices, int64_t n,
               int forward, int64_t *level)
{
    if (forward) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t lv = 0;
            for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
                int64_t j = indices[k];
                if (j < i && level[j] + 1 > lv) lv = level[j] + 1;
            }
            level[i] = lv;
        }
    } else {
        for (int64_t i = n - 1; i >= 0; --i) {
            int64_t lv = 0;
            for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
                int64_t j = indices[k];
                if (j > i && level[j] + 1 > lv) lv = level[j] + 1;
            }
            level[i] = lv;
        }
    }
}

/* ---------------------------------------------------------------------
 * ILU(k) and ILUT row-merge factorizations.
 *
 * Role of the reference's Euclid ILU(k) (distributed_ls/Euclid/
 * ilu_mpi_pilu.c level-of-fill pipeline) and par_ilu ILUT
 * (parcsr_ls/par_ilu_setup.c hypre_ILUSetupILUT, Saad's dual-threshold
 * scheme) — rebuilt natively so no external factorization library
 * (SuperLU) does the work.  Dense accumulator + occupied list per row;
 * outputs are malloc'd CSR triples released via ilu_free_ptr.
 * ------------------------------------------------------------------- */

typedef struct { int64_t *p, *i; double *x; int64_t nnz, cap; } csr_buf;

static void buf_init(csr_buf *b, int64_t n, int64_t cap0)
{
    b->p = (int64_t *)malloc((n + 1) * sizeof(int64_t));
    b->i = (int64_t *)malloc(cap0 * sizeof(int64_t));
    b->x = (double *)malloc(cap0 * sizeof(double));
    b->nnz = 0; b->cap = cap0; b->p[0] = 0;
}

static void buf_push(csr_buf *b, int64_t col, double val)
{
    if (b->nnz == b->cap) {
        b->cap *= 2;
        b->i = (int64_t *)realloc(b->i, b->cap * sizeof(int64_t));
        b->x = (double *)realloc(b->x, b->cap * sizeof(double));
    }
    b->i[b->nnz] = col; b->x[b->nnz] = val; b->nnz++;
}

void ilu_free_ptr(void *p) { free(p); }

/* occupied-list helpers: w dense values, mark[j] = 1 + slot in occ */
static int64_t occ_min_unprocessed(const int64_t *occ, const uint8_t *done,
                                   int64_t cnt, int64_t below)
{
    int64_t best = -1, bj = 0;
    for (int64_t t = 0; t < cnt; ++t) {
        if (done[t] || occ[t] >= below) continue;
        if (best < 0 || occ[t] < (int64_t)bj) { best = t; bj = occ[t]; }
    }
    return best;
}

int iluk_factor(const int64_t *indptr, const int64_t *indices,
                const double *data, int64_t n, int maxfill,
                int64_t **Lp_o, int64_t **Li_o, double **Lx_o,
                int64_t **Up_o, int64_t **Ui_o, double **Ux_o)
{
    csr_buf L, U;
    int64_t nnz0 = indptr[n];
    buf_init(&L, n, nnz0 + 16);
    buf_init(&U, n, nnz0 + 16);
    /* levels of U entries, parallel to U.i */
    int64_t ulev_cap = U.cap;
    int32_t *ulev = (int32_t *)malloc(ulev_cap * sizeof(int32_t));

    double *w = (double *)calloc(n, sizeof(double));
    int32_t *lev = (int32_t *)malloc(n * sizeof(int32_t));
    int64_t *pos = (int64_t *)malloc(n * sizeof(int64_t)); /* col -> occ slot+1 */
    int64_t *occ = (int64_t *)malloc(n * sizeof(int64_t));
    uint8_t *done = (uint8_t *)malloc(n);
    for (int64_t j = 0; j < n; ++j) pos[j] = 0;

    for (int64_t i = 0; i < n; ++i) {
        int64_t cnt = 0;
        for (int64_t q = indptr[i]; q < indptr[i + 1]; ++q) {
            int64_t j = indices[q];
            w[j] = data[q]; lev[j] = 0;
            occ[cnt] = j; done[cnt] = 0; pos[j] = cnt + 1; cnt++;
        }
        for (;;) {
            int64_t t = occ_min_unprocessed(occ, done, cnt, i);
            if (t < 0) break;
            done[t] = 1;
            int64_t k = occ[t];
            /* U diag of row k is U.x at U.p[k] (stored first, sorted) */
            double dk = 0.0;
            int64_t us = U.p[k], ue = U.p[k + 1];
            if (ue > us && U.i[us] == k) dk = U.x[us];
            if (dk == 0.0) { continue; }
            double f = w[k] / dk;
            w[k] = f;
            for (int64_t q = us + 1; q < ue; ++q) {
                int64_t j = U.i[q];
                int32_t nl = lev[k] + ulev[q] + 1;
                if (pos[j]) {
                    w[j] -= f * U.x[q];
                    if (nl < lev[j]) lev[j] = nl;
                } else if (nl <= maxfill) {
                    w[j] = -f * U.x[q]; lev[j] = nl;
                    occ[cnt] = j; done[cnt] = 0; pos[j] = cnt + 1; cnt++;
                }
            }
        }
        /* emit row i: sort occupied ascending (insertion into small buf) */
        for (int64_t a = 1; a < cnt; ++a) {  /* insertion sort on occ */
            int64_t v = occ[a]; int64_t b = a - 1;
            while (b >= 0 && occ[b] > v) { occ[b + 1] = occ[b]; b--; }
            occ[b + 1] = v;
        }
        /* the elimination relies on U.i[U.p[k]] == k (diag stored
         * first); a structurally-missing diagonal must therefore be
         * inserted BEFORE the row's j > i entries, not appended
         * (ADVICE r2: appending made later rows skip elimination
         * against this row as a silent zero pivot) */
        int has_diag = 0;
        for (int64_t t = 0; t < cnt; ++t)
            if (occ[t] == i) { has_diag = 1; break; }
        if (!has_diag) {
            buf_push(&U, i, 1e-30);
            if (U.cap > ulev_cap) {
                ulev = (int32_t *)realloc(ulev, U.cap * sizeof(int32_t));
                ulev_cap = U.cap;
            }
            ulev[U.nnz - 1] = 0;
        }
        for (int64_t t = 0; t < cnt; ++t) {
            int64_t j = occ[t];
            if (j < i) buf_push(&L, j, w[j]);
            else {
                buf_push(&U, j, (j == i && w[j] == 0.0) ? 1e-30 : w[j]);
                if (U.cap > ulev_cap) {
                    ulev = (int32_t *)realloc(ulev, U.cap * sizeof(int32_t));
                    ulev_cap = U.cap;
                }
                ulev[U.nnz - 1] = lev[j];
            }
            w[j] = 0.0; pos[j] = 0;
        }
        L.p[i + 1] = L.nnz;
        U.p[i + 1] = U.nnz;
    }
    free(w); free(lev); free(pos); free(occ); free(done); free(ulev);
    *Lp_o = L.p; *Li_o = L.i; *Lx_o = L.x;
    *Up_o = U.p; *Ui_o = U.i; *Ux_o = U.x;
    return 0;
}

static int cmp_absdesc(const void *a, const void *b)
{
    double x = ((const double *)a)[1], y = ((const double *)b)[1];
    double ax = x < 0 ? -x : x, ay = y < 0 ? -y : y;
    if (ax < ay) return 1;
    if (ax > ay) return -1;
    return 0;
}

int ilut_factor(const int64_t *indptr, const int64_t *indices,
                const double *data, int64_t n, double droptol,
                int64_t maxrow,
                int64_t **Lp_o, int64_t **Li_o, double **Lx_o,
                int64_t **Up_o, int64_t **Ui_o, double **Ux_o)
{
    csr_buf L, U;
    int64_t nnz0 = indptr[n];
    buf_init(&L, n, nnz0 + 16);
    buf_init(&U, n, nnz0 + 16);
    double *w = (double *)calloc(n, sizeof(double));
    int64_t *pos = (int64_t *)malloc(n * sizeof(int64_t));
    int64_t *occ = (int64_t *)malloc(n * sizeof(int64_t));
    uint8_t *done = (uint8_t *)malloc(n);
    double *sel = (double *)malloc(2 * n * sizeof(double));
    for (int64_t j = 0; j < n; ++j) pos[j] = 0;

    for (int64_t i = 0; i < n; ++i) {
        double nrm = 0.0;
        int64_t rl = indptr[i + 1] - indptr[i];
        int64_t cnt = 0;
        for (int64_t q = indptr[i]; q < indptr[i + 1]; ++q) {
            int64_t j = indices[q];
            w[j] = data[q]; nrm += data[q] * data[q];
            occ[cnt] = j; done[cnt] = 0; pos[j] = cnt + 1; cnt++;
        }
        double tau = droptol * sqrt(nrm);  /* Saad: relative to row 2-norm */
        for (;;) {
            int64_t t = occ_min_unprocessed(occ, done, cnt, i);
            if (t < 0) break;
            done[t] = 1;
            int64_t k = occ[t];
            double ak = w[k] < 0 ? -w[k] : w[k];
            if (ak < tau) { w[k] = 0.0; continue; }  /* drop small pivot */
            double dk = 0.0;
            int64_t us = U.p[k], ue = U.p[k + 1];
            if (ue > us && U.i[us] == k) dk = U.x[us];
            if (dk == 0.0) continue;
            double f = w[k] / dk;
            w[k] = f;
            for (int64_t q = us + 1; q < ue; ++q) {
                int64_t j = U.i[q];
                double upd = -f * U.x[q];
                if (pos[j]) w[j] += upd;
                else if ((upd < 0 ? -upd : upd) >= tau) {
                    w[j] = upd;
                    occ[cnt] = j; done[cnt] = 0; pos[j] = cnt + 1; cnt++;
                }
            }
        }
        /* dual-threshold selection: keep maxrow largest |.| per part */
        int64_t nl = 0, nu = 0;
        double diag = 0.0;
        for (int64_t t = 0; t < cnt; ++t) {
            int64_t j = occ[t];
            double v = w[j];
            double av = v < 0 ? -v : v;
            if (j == i) diag = v;
            else if (j < i) { sel[2 * nl] = (double)j; sel[2 * nl + 1] = v; nl++; }
            else { sel[2 * (n - 1 - nu)] = (double)j; sel[2 * (n - 1 - nu) + 1] = v; nu++; }
            w[j] = 0.0; pos[j] = 0;
        }
        qsort(sel, nl, 2 * sizeof(double), cmp_absdesc);
        int64_t keepl = nl < maxrow ? nl : maxrow;
        /* re-sort kept L entries by column */
        for (int64_t a = 1; a < keepl; ++a) {
            double c0 = sel[2 * a], v0 = sel[2 * a + 1];
            int64_t b = a - 1;
            while (b >= 0 && sel[2 * b] > c0) {
                sel[2 * (b + 1)] = sel[2 * b]; sel[2 * (b + 1) + 1] = sel[2 * b + 1]; b--;
            }
            sel[2 * (b + 1)] = c0; sel[2 * (b + 1) + 1] = v0;
        }
        for (int64_t a = 0; a < keepl; ++a) {
            double av = sel[2 * a + 1] < 0 ? -sel[2 * a + 1] : sel[2 * a + 1];
            if (av >= tau) buf_push(&L, (int64_t)sel[2 * a], sel[2 * a + 1]);
        }
        buf_push(&U, i, diag == 0.0 ? 1e-30 : diag);
        double *su = sel + 2 * (n - nu);
        qsort(su, nu, 2 * sizeof(double), cmp_absdesc);
        int64_t keepu = nu < maxrow ? nu : maxrow;
        for (int64_t a = 1; a < keepu; ++a) {
            double c0 = su[2 * a], v0 = su[2 * a + 1];
            int64_t b = a - 1;
            while (b >= 0 && su[2 * b] > c0) {
                su[2 * (b + 1)] = su[2 * b]; su[2 * (b + 1) + 1] = su[2 * b + 1]; b--;
            }
            su[2 * (b + 1)] = c0; su[2 * (b + 1) + 1] = v0;
        }
        for (int64_t a = 0; a < keepu; ++a) {
            double av = su[2 * a + 1] < 0 ? -su[2 * a + 1] : su[2 * a + 1];
            if (av >= tau) buf_push(&U, (int64_t)su[2 * a], su[2 * a + 1]);
        }
        L.p[i + 1] = L.nnz;
        U.p[i + 1] = U.nnz;
    }
    free(w); free(pos); free(occ); free(done); free(sel);
    *Lp_o = L.p; *Li_o = L.i; *Lx_o = L.x;
    *Up_o = U.p; *Ui_o = U.i; *Ux_o = U.x;
    return 0;
}
