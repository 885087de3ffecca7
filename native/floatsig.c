/* floatsig: bit-exact native twin of the segment stage's scipy float
 * surface (freddie_jax/ops/signal.py; reference calls at
 * /root/reference/py/freddie_segment.py:755,615-621,249-266).
 *
 * Replicates, operation for operation:
 *   - scipy.ndimage.correlate1d's NI_Correlate1D symmetric inner loop
 *     (center product first, then (left+right)*w pairs from the farthest
 *     offset inward) with 'reflect' and 'constant' boundary extension.
 *     The Gaussian kernel WEIGHTS are computed in Python with the exact
 *     numpy expression scipy uses and passed in, so no exp() rounding can
 *     diverge.
 *   - scipy.signal._peak_finding_utils._local_maxima_1d (plateau
 *     midpoints, strict < on both flanks, edges excluded).
 *   - _select_by_peak_distance (argsort by priority ascending, iterate
 *     from the highest, ceil(distance)). numpy's argsort order is only
 *     observable when two peak priorities tie EXACTLY; in that case the
 *     refine call returns None and the caller falls back to scipy for the
 *     interval (content-only dispatch, deterministic across machines;
 *     measured 0/1998 smoothed intervals in the fuzz).
 *   - Python round() (round-half-even, = nearbyint under the default FP
 *     rounding mode) and Python slice semantics for the +-sigma mass sum,
 *     which is a LEFT-TO-RIGHT sequential float sum like the reference's
 *     builtin sum().
 *
 * The raw splice signal is integer-valued float64 (bincount of integer
 * multiplicities), so the refine gate `vals.sum() < min_splice` is exact
 * under any summation order; all other sums replicate scipy's order.
 *
 * Built with -ffp-contract=off so no FMA contraction can change results
 * vs scipy's non-contracted binaries.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>

/* ---- NI_Correlate1D symmetric replica ---------------------------------- */

/* scipy 'reflect' extension index: (d c b a | a b c d | d c b a), valid for
 * any offset via the period-2n closed form. */
static Py_ssize_t reflect_idx(Py_ssize_t i, Py_ssize_t n) {
    Py_ssize_t period = 2 * n;
    i %= period;
    if (i < 0) i += period;
    if (i >= n) i = period - 1 - i;
    return i;
}

/* out[0..n) = correlate1d(y, w) with a symmetric odd kernel of half-width
 * size1 (w has 2*size1+1 entries, center at w[size1]).
 * mode: 0 = reflect, 1 = constant cval=0. ext is scratch of n+2*size1. */
static void correlate1d_sym(const double *y, Py_ssize_t n, const double *w,
                            Py_ssize_t size1, int mode, double *ext,
                            double *out) {
    Py_ssize_t i, ll, jj;
    memcpy(ext + size1, y, (size_t)n * sizeof(double));
    if (mode == 0) {
        for (i = 0; i < size1; i++) {
            ext[size1 - 1 - i] = y[reflect_idx(-1 - i, n)];
            ext[size1 + n + i] = y[reflect_idx(n + i, n)];
        }
    } else {
        for (i = 0; i < size1; i++) {
            ext[i] = 0.0;
            ext[size1 + n + i] = 0.0;
        }
    }
    for (ll = 0; ll < n; ll++) {
        const double *c = ext + size1 + ll;
        double s = c[0] * w[size1];
        for (jj = -size1; jj < 0; jj++)
            s += (c[jj] + c[-jj]) * w[size1 + jj];
        out[ll] = s;
    }
}

/* ---- _local_maxima_1d replica ------------------------------------------ */

/* Returns the number of midpoints written to mids (caller provides n/2). */
static Py_ssize_t local_maxima(const double *x, Py_ssize_t n,
                               Py_ssize_t *mids) {
    Py_ssize_t cnt = 0, i = 1, i_max = n - 1;
    while (i < i_max) {
        if (x[i - 1] < x[i]) {
            Py_ssize_t i_ahead = i + 1;
            while (i_ahead < i_max && x[i_ahead] == x[i]) i_ahead++;
            if (x[i_ahead] < x[i]) {
                Py_ssize_t left = i, right = i_ahead - 1;
                mids[cnt++] = (left + right) / 2;
                i = i_ahead;
            }
        }
        i++;
    }
    return cnt;
}

/* ---- _select_by_peak_distance replica ---------------------------------- */

typedef struct { double pri; Py_ssize_t pos; } PriPos;

static int pripos_cmp(const void *a, const void *b) {
    const PriPos *x = (const PriPos *)a, *y = (const PriPos *)b;
    if (x->pri < y->pri) return -1;
    if (x->pri > y->pri) return 1;
    /* ties are rejected before sorting; stabilize by position anyway */
    return (x->pos > y->pos) - (x->pos < y->pos);
}

/* keep[j] = 1 to retain peak j. Returns 0 on success, -1 if any two
 * priorities tie exactly (numpy argsort order unobservable -> caller must
 * fall back to scipy). */
static int select_by_distance(const Py_ssize_t *peaks, const double *pri,
                              Py_ssize_t n, double distance, char *keep,
                              PriPos *scratch) {
    Py_ssize_t i, j, k;
    double d = ceil(distance);
    for (i = 0; i < n; i++) {
        scratch[i].pri = pri[i];
        scratch[i].pos = i;
        keep[i] = 1;
    }
    qsort(scratch, (size_t)n, sizeof(PriPos), pripos_cmp);
    for (i = 1; i < n; i++)
        if (scratch[i].pri == scratch[i - 1].pri) return -1;
    for (i = n - 1; i >= 0; i--) {
        j = scratch[i].pos;
        if (!keep[j]) continue;
        k = j - 1;
        while (k >= 0 && (double)(peaks[j] - peaks[k]) < d) {
            keep[k] = 0;
            k--;
        }
        k = j + 1;
        while (k < n && (double)(peaks[k] - peaks[j]) < d) {
            keep[k] = 0;
            k++;
        }
    }
    return 0;
}

/* ---- module functions --------------------------------------------------- */

/* surface(y_raws: sequence of float64 buffers, kernel: bytes)
 *   -> (list[bytes smoothed], list[list[int] candidates])
 * Smoothing: reflect mode (truncate=4.0 kernel passed in). Candidates:
 * sorted(set(find_peaks(smoothed) + {0, n-1})) -- peak midpoints are
 * strictly inside (0, n-1) and ascending, so this is [0, mids..., n-1]. */
static PyObject *py_surface(PyObject *self, PyObject *args) {
    PyObject *ys_obj;
    Py_buffer kbuf;
    if (!PyArg_ParseTuple(args, "Oy*", &ys_obj, &kbuf)) return NULL;
    PyObject *seq = PySequence_Fast(ys_obj, "y_raws must be a sequence");
    if (!seq) {
        PyBuffer_Release(&kbuf);
        return NULL;
    }
    Py_ssize_t n_iv = PySequence_Fast_GET_SIZE(seq);
    Py_ssize_t ksize = (Py_ssize_t)(kbuf.len / sizeof(double));
    const double *w = (const double *)kbuf.buf;
    Py_ssize_t size1 = ksize / 2;
    PyObject *sm_list = PyList_New(n_iv);
    PyObject *cand_list = PyList_New(n_iv);
    double *ext = NULL, *out = NULL;
    Py_ssize_t *mids = NULL;
    Py_ssize_t cap = 0;
    if (!sm_list || !cand_list || ksize < 1 || ksize % 2 == 0) goto fail;
    for (Py_ssize_t iv = 0; iv < n_iv; iv++) {
        Py_buffer yb;
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(seq, iv), &yb,
                               PyBUF_CONTIG_RO) < 0)
            goto fail;
        Py_ssize_t n = (Py_ssize_t)(yb.len / sizeof(double));
        const double *y = (const double *)yb.buf;
        if (n + 2 > cap) {
            cap = n + 2;
            free(ext); free(out); free(mids);
            ext = (double *)malloc((size_t)(cap + 2 * size1) * sizeof(double));
            out = (double *)malloc((size_t)cap * sizeof(double));
            mids = (Py_ssize_t *)malloc((size_t)cap * sizeof(Py_ssize_t));
            if (!ext || !out || !mids) {
                PyBuffer_Release(&yb);
                PyErr_NoMemory();
                goto fail;
            }
        }
        correlate1d_sym(y, n, w, size1, 0, ext, out);
        Py_ssize_t n_mid = local_maxima(out, n, mids);
        PyObject *sm = PyBytes_FromStringAndSize((const char *)out,
                                                 n * (Py_ssize_t)sizeof(double));
        PyBuffer_Release(&yb);
        if (!sm) goto fail;
        PyList_SET_ITEM(sm_list, iv, sm);
        Py_ssize_t n_c = (n >= 2) ? n_mid + 2 : 1;
        PyObject *cl = PyList_New(n_c);
        if (!cl) goto fail;
        Py_ssize_t p = 0;
        PyList_SET_ITEM(cl, p++, PyLong_FromSsize_t(0));
        if (n >= 2) {
            for (Py_ssize_t m = 0; m < n_mid; m++)
                PyList_SET_ITEM(cl, p++, PyLong_FromSsize_t(mids[m]));
            PyList_SET_ITEM(cl, p++, PyLong_FromSsize_t(n - 1));
        }
        PyList_SET_ITEM(cand_list, iv, cl);
    }
    free(ext); free(out); free(mids);
    PyBuffer_Release(&kbuf);
    Py_DECREF(seq);
    return Py_BuildValue("(NN)", sm_list, cand_list);
fail:
    free(ext); free(out); free(mids);
    PyBuffer_Release(&kbuf);
    Py_DECREF(seq);
    Py_XDECREF(sm_list);
    Py_XDECREF(cand_list);
    if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "floatsig.surface: bad input");
    return NULL;
}

/* refine(y_raw: float64 buffer, final_ys: sequence of int, kernel: bytes,
 *        sigma: float, skip: int, min_splice: float)
 *   -> (list[int], list[(s, g_bytes, peaks_list)])
 * Replicates ops/signal.py:refine_segmentation for every segment whose
 * peak priorities are all distinct. Segments with an EXACT priority tie
 * (common on integer-valued splice signals: identical isolated patterns
 * smooth to identical peak heights) are deferred: the C-computed smoothed
 * signal g and the plateau-midpoint peaks are returned so Python can run
 * the distance selection with numpy's own argsort -- the only operation
 * whose tie order this module cannot reproduce. */
static PyObject *py_refine(PyObject *self, PyObject *args) {
    Py_buffer yb, kbuf;
    PyObject *fys_obj;
    double sigma, min_splice;
    Py_ssize_t skip;
    if (!PyArg_ParseTuple(args, "y*Oy*dnd", &yb, &fys_obj, &kbuf, &sigma,
                          &skip, &min_splice))
        return NULL;
    PyObject *seq = PySequence_Fast(fys_obj, "final_ys must be a sequence");
    if (!seq) {
        PyBuffer_Release(&yb);
        PyBuffer_Release(&kbuf);
        return NULL;
    }
    Py_ssize_t n_y = (Py_ssize_t)(yb.len / sizeof(double));
    const double *y_raw = (const double *)yb.buf;
    Py_ssize_t ksize = (Py_ssize_t)(kbuf.len / sizeof(double));
    const double *w = (const double *)kbuf.buf;
    Py_ssize_t size1 = ksize / 2;
    Py_ssize_t n_f = PySequence_Fast_GET_SIZE(seq);
    PyObject *out_list = PyList_New(0);
    PyObject *tie_list = PyList_New(0);
    double *vals = NULL, *ext = NULL, *g = NULL, *pri = NULL;
    Py_ssize_t *mids = NULL;
    char *keep = NULL;
    PriPos *scratch = NULL;
    Py_ssize_t cap = 0;
    if (!out_list || !tie_list || ksize < 1 || ksize % 2 == 0) goto fail;
    for (Py_ssize_t si = 0; si + 1 < n_f; si++) {
        Py_ssize_t s = PyLong_AsSsize_t(PySequence_Fast_GET_ITEM(seq, si));
        Py_ssize_t e = PyLong_AsSsize_t(PySequence_Fast_GET_ITEM(seq, si + 1));
        if (PyErr_Occurred()) goto fail;
        if (e - s <= 2 * skip) continue;
        if (s < 0 || e > n_y) goto fail;
        Py_ssize_t n = e - s;
        if (n + 2 > cap) {
            cap = n + 2;
            free(vals); free(ext); free(g); free(mids); free(keep);
            free(pri); free(scratch);
            vals = (double *)malloc((size_t)cap * sizeof(double));
            ext = (double *)malloc((size_t)(cap + 2 * size1) * sizeof(double));
            g = (double *)malloc((size_t)cap * sizeof(double));
            mids = (Py_ssize_t *)malloc((size_t)cap * sizeof(Py_ssize_t));
            keep = (char *)malloc((size_t)cap);
            pri = (double *)malloc((size_t)cap * sizeof(double));
            scratch = (PriPos *)malloc((size_t)cap * sizeof(PriPos));
            if (!vals || !ext || !g || !mids || !keep || !pri || !scratch) {
                PyErr_NoMemory();
                goto fail;
            }
        }
        memcpy(vals, y_raw + s, (size_t)n * sizeof(double));
        for (Py_ssize_t i = 0; i < skip && i < n; i++) vals[i] = 0.0;
        for (Py_ssize_t i = n - skip; i < n; i++)
            if (i >= 0) vals[i] = 0.0;
        /* vals is integer-valued (bincount of integer multiplicities):
         * the gate sum is exact under any order, so a plain left-to-right
         * sum equals np.sum bitwise. */
        double tot = 0.0;
        for (Py_ssize_t i = 0; i < n; i++) tot += vals[i];
        if (tot < min_splice) continue;
        correlate1d_sym(vals, n, w, size1, 1, ext, g);
        Py_ssize_t n_mid = local_maxima(g, n, mids);
        if (n_mid == 0) continue;
        for (Py_ssize_t m = 0; m < n_mid; m++) pri[m] = g[mids[m]];
        if (select_by_distance(mids, pri, n_mid, (double)skip, keep,
                               scratch) < 0) {
            /* exact priority tie: defer this segment to Python */
            PyObject *pk = PyList_New(n_mid);
            if (!pk) goto fail;
            for (Py_ssize_t m = 0; m < n_mid; m++)
                PyList_SET_ITEM(pk, m, PyLong_FromSsize_t(mids[m]));
            PyObject *ent = Py_BuildValue(
                "(ny#N)", s, (const char *)g,
                n * (Py_ssize_t)sizeof(double), pk);
            if (!ent || PyList_Append(tie_list, ent) < 0) {
                Py_XDECREF(ent);
                goto fail;
            }
            Py_DECREF(ent);
            continue;
        }
        for (Py_ssize_t m = 0; m < n_mid; m++) {
            if (!keep[m]) continue;
            Py_ssize_t i = mids[m];
            /* Python round() = round-half-even = nearbyint (default FP
             * rounding mode); then Python slice semantics on g[lo:hi]. */
            double lo_f = nearbyint((double)i - sigma);
            double hi_f = nearbyint((double)i + sigma + 1.0);
            Py_ssize_t lo = (Py_ssize_t)lo_f, hi = (Py_ssize_t)hi_f;
            Py_ssize_t start, stop;
            if (lo < 0) { start = n + lo; if (start < 0) start = 0; }
            else { start = lo < n ? lo : n; }
            if (hi < 0) { stop = n + hi; if (stop < 0) stop = 0; }
            else { stop = hi < n ? hi : n; }
            double mass = 0.0; /* left-to-right like builtin sum() */
            for (Py_ssize_t k = start; k < stop; k++) mass += g[k];
            if (mass < min_splice) continue;
            PyObject *v = PyLong_FromSsize_t(i + s);
            if (!v || PyList_Append(out_list, v) < 0) {
                Py_XDECREF(v);
                goto fail;
            }
            Py_DECREF(v);
        }
    }
    free(vals); free(ext); free(g); free(mids); free(keep); free(pri);
    free(scratch);
    PyBuffer_Release(&yb);
    PyBuffer_Release(&kbuf);
    Py_DECREF(seq);
    return Py_BuildValue("(NN)", out_list, tie_list);
fail:
    free(vals); free(ext); free(g); free(mids); free(keep); free(pri);
    free(scratch);
    PyBuffer_Release(&yb);
    PyBuffer_Release(&kbuf);
    Py_DECREF(seq);
    Py_XDECREF(out_list);
    Py_XDECREF(tie_list);
    if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "floatsig.refine: bad input");
    return NULL;
}

static PyMethodDef Methods[] = {
    {"surface", py_surface, METH_VARARGS,
     "smooth (reflect) + peak candidates per interval"},
    {"refine", py_refine, METH_VARARGS,
     "refine_segmentation twin; None on exact priority tie"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "floatsig", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit_floatsig(void) { return PyModule_Create(&moduledef); }
