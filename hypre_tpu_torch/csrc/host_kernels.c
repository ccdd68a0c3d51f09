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
