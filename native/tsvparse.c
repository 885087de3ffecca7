/* CPython extension: one-pass split-TSV parsing.
 *
 * Native twin of the header/read-row parsing inside
 * freddie_jax/io/tsv.py:parse_split_tsv (the wire format is
 * /root/reference/py/freddie_split.py:445-481; the reference re-parses it
 * per stage with compiled regexes, py/freddie_segment.py:17-38). The
 * Python parser dominated the production segment stage's host time
 * (~1.9 s of 7.5 s on the 26k-read bench dataset, half of it re-parsing
 * CIGAR strings); this extension builds the identical tuples in one C
 * pass. The Python implementation remains the semantic oracle
 * (tests/test_native_tsvparse.py compares object-for-object) and the
 * runtime fallback.
 *
 * parse_split_file(path, opcodes) ->
 *   (chrom, tint_id, tint_intervals, read_count, reads, reps)
 *   tint_intervals: [(s, e), ...]
 *   reads: [(rid, name, chrom, strand, tint, ivs)], one per row
 *   ivs:   [(ts, te, qs, qe, cigar)], cigar: [(op_code, length), ...]
 *   with op_code = index of the op char in `opcodes` (io.bam.CIGAR_OPS).
 *   reps:  [(key, [row_idx, ...])] grouping rows that share the same
 *   ((ts, te), ...) exonic-interval tuple, in first-seen order -- the
 *   read representatives of py/freddie_segment.py:163-170, computed
 *   here so the Python side needn't re-walk every row's intervals.
 *
 * Every structural assertion of the Python parser is replicated as an
 * AssertionError with the same meaning; malformed numerics raise
 * ValueError.
 *
 * Build: gcc -O2 -shared -fPIC -I<python-include> -o tsvparse.so tsvparse.c
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static int fail_assert(const char* msg) {
  PyErr_SetString(PyExc_AssertionError, msg);
  return -1;
}

/* Parse a non-negative decimal starting at *p; advance *p. -1 on error. */
static long long parse_ll(const char** p, const char* end) {
  const char* s = *p;
  if (s >= end || *s < '0' || *s > '9') return -1;
  long long v = 0;
  while (s < end && *s >= '0' && *s <= '9') {
    v = v * 10 + (*s - '0');
    ++s;
  }
  *p = s;
  return v;
}

static PyObject* parse_split_file(PyObject* self, PyObject* args) {
  const char* path;
  const char* opcodes;
  Py_ssize_t n_ops;
  if (!PyArg_ParseTuple(args, "ss#", &path, &opcodes, &n_ops)) return NULL;

  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return NULL;
  }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc((size_t)fsize + 1);
  if (!buf || fread(buf, 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    free(buf);
    PyErr_SetString(PyExc_OSError, "short read");
    return NULL;
  }
  fclose(f);
  buf[fsize] = '\n'; /* sentinel so the last line always terminates */

  int op_of[256];
  for (int i = 0; i < 256; ++i) op_of[i] = -1;
  for (Py_ssize_t i = 0; i < n_ops; ++i) op_of[(unsigned char)opcodes[i]] = (int)i;

  PyObject* chrom = NULL;
  PyObject* tint_intervals = NULL;
  PyObject* reads = PyList_New(0);
  PyObject* reps_dict = PyDict_New(); /* key tuple -> [row idx, ...] */
  long long tint_id = -1, read_count = -1;
  int have_header = 0;
  if (!reads || !reps_dict) goto error;

  const char* p = buf;
  const char* bend = buf + fsize;

#define FAIL(msg)                 \
  do {                            \
    fail_assert(msg);             \
    goto error;                   \
  } while (0)
#define VFAIL(msg)                       \
  do {                                   \
    PyErr_SetString(PyExc_ValueError, msg); \
    goto error;                          \
  } while (0)

  while (p < bend) {
    const char* eol = memchr(p, '\n', (size_t)(bend - p + 1));
    if (!eol) eol = bend;
    const char* line = p;
    const char* lend = eol;
    p = eol + 1;
    if (line == lend) continue; /* blank */

    if (*line == '#') {
      if (have_header) FAIL("multiple tints in one split file");
      have_header = 1;
      /* fields: #chrom \t tint \t s-e,s-e,... \t n_reads */
      const char* t1 = memchr(line, '\t', (size_t)(lend - line));
      if (!t1) VFAIL("header: missing fields");
      chrom = PyUnicode_FromStringAndSize(line + 1, t1 - line - 1);
      if (!chrom) goto error;
      const char* q = t1 + 1;
      tint_id = parse_ll(&q, lend);
      if (tint_id < 0 || q >= lend || *q != '\t') VFAIL("header: bad tint id");
      ++q;
      tint_intervals = PyList_New(0);
      if (!tint_intervals) goto error;
      long long prev_e = -1;
      while (1) {
        long long s = parse_ll(&q, lend);
        if (s < 0 || q >= lend || *q != '-') VFAIL("header: bad interval");
        ++q;
        long long e = parse_ll(&q, lend);
        if (e < 0) VFAIL("header: bad interval");
        if (!(s < e)) FAIL("header: interval start >= end");
        if (prev_e >= 0 && !(prev_e < s)) FAIL("header: intervals not sorted");
        prev_e = e;
        PyObject* iv = Py_BuildValue("(LL)", s, e);
        if (!iv || PyList_Append(tint_intervals, iv) < 0) {
          Py_XDECREF(iv);
          goto error;
        }
        Py_DECREF(iv);
        if (q < lend && *q == ',') {
          ++q;
          continue;
        }
        break;
      }
      if (q >= lend || *q != '\t') VFAIL("header: missing read count");
      ++q;
      read_count = parse_ll(&q, lend);
      if (read_count < 0 || q != lend) VFAIL("header: bad read count");
      continue;
    }

    /* read row: rid \t name \t chrom \t strand \t tint \t ivfield... */
    const char* q = line;
    long long rid = parse_ll(&q, lend);
    if (rid < 0 || q >= lend || *q != '\t') VFAIL("row: bad rid");
    ++q;
    const char* name_s = q;
    const char* t = memchr(q, '\t', (size_t)(lend - q));
    if (!t) VFAIL("row: missing name end");
    PyObject* name = PyUnicode_FromStringAndSize(name_s, t - name_s);
    q = t + 1;
    t = memchr(q, '\t', (size_t)(lend - q));
    if (!t) {
      Py_XDECREF(name);
      VFAIL("row: missing chrom end");
    }
    PyObject* rchrom = PyUnicode_FromStringAndSize(q, t - q);
    q = t + 1;
    t = memchr(q, '\t', (size_t)(lend - q));
    if (!t) {
      Py_XDECREF(name);
      Py_XDECREF(rchrom);
      VFAIL("row: missing strand end");
    }
    PyObject* strand = PyUnicode_FromStringAndSize(q, t - q);
    q = t + 1;
    long long rtint = parse_ll(&q, lend);
    PyObject* ivs = NULL;
    if (rtint < 0 || q >= lend || *q != '\t') {
      Py_XDECREF(name);
      Py_XDECREF(rchrom);
      Py_XDECREF(strand);
      VFAIL("row: bad tint");
    }
    ++q;
    ivs = PyList_New(0);
    PyObject* keys = PyList_New(0); /* ((ts, te), ...) rep-grouping key */
    long long prev_te = -1, prev_qe = -1;
    /* interval fields separated by \t; each = ts-te:qs-qe:CIGAR */
    while (q <= lend) {
      const char* fend = memchr(q, '\t', (size_t)(lend - q));
      if (!fend) fend = lend;
      long long ts = parse_ll(&q, fend);
      if (ts < 0 || q >= fend || *q != '-') goto row_value_error;
      ++q;
      long long te = parse_ll(&q, fend);
      if (te < 0 || q >= fend || *q != ':') goto row_value_error;
      ++q;
      long long qs = parse_ll(&q, fend);
      if (qs < 0 || q >= fend || *q != '-') goto row_value_error;
      ++q;
      long long qe = parse_ll(&q, fend);
      if (qe < 0 || q >= fend || *q != ':') goto row_value_error;
      ++q;
      /* CIGAR until fend */
      PyObject* cig = PyList_New(0);
      if (!cig) goto row_error;
      while (q < fend) {
        long long n = parse_ll(&q, fend);
        if (n < 0 || q >= fend) {
          Py_DECREF(cig);
          goto row_value_error;
        }
        int op = op_of[(unsigned char)*q];
        if (op < 0) {
          Py_DECREF(cig);
          goto row_value_error;
        }
        ++q;
        PyObject* el = Py_BuildValue("(iL)", op, n);
        if (!el || PyList_Append(cig, el) < 0) {
          Py_XDECREF(el);
          Py_DECREF(cig);
          goto row_error;
        }
        Py_DECREF(el);
      }
      if (!(ts < te && qs < qe)) {
        Py_DECREF(cig);
        Py_XDECREF(name);
        Py_XDECREF(rchrom);
        Py_XDECREF(strand);
        Py_XDECREF(ivs);
        Py_XDECREF(keys);
        FAIL("row: empty interval");
      }
      if (prev_te >= 0 && !(prev_te <= ts && prev_qe <= qs)) {
        Py_DECREF(cig);
        Py_XDECREF(name);
        Py_XDECREF(rchrom);
        Py_XDECREF(strand);
        Py_XDECREF(ivs);
        Py_XDECREF(keys);
        FAIL("row: intervals not sorted");
      }
      prev_te = te;
      prev_qe = qe;
      PyObject* iv = Py_BuildValue("(LLLLN)", ts, te, qs, qe, cig);
      if (!iv || PyList_Append(ivs, iv) < 0) {
        Py_XDECREF(iv);
        goto row_error;
      }
      Py_DECREF(iv);
      PyObject* kv = Py_BuildValue("(LL)", ts, te);
      if (!kv || PyList_Append(keys, kv) < 0) {
        Py_XDECREF(kv);
        goto row_error;
      }
      Py_DECREF(kv);
      if (fend == lend) break;
      q = fend + 1;
    }
    {
      PyObject* row = Py_BuildValue("(LNNNLN)", rid, name, rchrom, strand,
                                    rtint, ivs);
      if (!row || PyList_Append(reads, row) < 0) {
        Py_XDECREF(row);
        Py_DECREF(keys);
        goto error;
      }
      Py_DECREF(row);
    }
    {
      /* Read representatives: group this row under its exonic-interval
       * key (CPython dicts iterate in insertion order, matching the
       * Python oracle's setdefault loop). */
      PyObject* key_tuple = PyList_AsTuple(keys);
      Py_DECREF(keys);
      if (!key_tuple) goto error;
      PyObject* lst = PyDict_GetItem(reps_dict, key_tuple); /* borrowed */
      if (!lst) {
        PyObject* fresh = PyList_New(0);
        if (!fresh || PyDict_SetItem(reps_dict, key_tuple, fresh) < 0) {
          Py_XDECREF(fresh);
          Py_DECREF(key_tuple);
          goto error;
        }
        Py_DECREF(fresh);
        lst = PyDict_GetItem(reps_dict, key_tuple);
      }
      Py_DECREF(key_tuple);
      PyObject* idx = PyLong_FromSsize_t(PyList_GET_SIZE(reads) - 1);
      if (!idx || !lst || PyList_Append(lst, idx) < 0) {
        Py_XDECREF(idx);
        goto error;
      }
      Py_DECREF(idx);
    }
    continue;
  row_value_error:
    PyErr_SetString(PyExc_ValueError, "row: bad interval field");
  row_error:
    Py_XDECREF(name);
    Py_XDECREF(rchrom);
    Py_XDECREF(strand);
    Py_XDECREF(ivs);
    Py_XDECREF(keys);
    goto error;
  }

  if (!have_header) FAIL("no tint header");
  {
    PyObject* reps = PyList_New(0);
    if (!reps) goto error;
    Py_ssize_t dpos = 0;
    PyObject *dk, *dv;
    while (PyDict_Next(reps_dict, &dpos, &dk, &dv)) {
      PyObject* pair = Py_BuildValue("(OO)", dk, dv);
      if (!pair || PyList_Append(reps, pair) < 0) {
        Py_XDECREF(pair);
        Py_DECREF(reps);
        goto error;
      }
      Py_DECREF(pair);
    }
    Py_DECREF(reps_dict);
    free(buf);
    return Py_BuildValue("(NLNLNN)", chrom, tint_id, tint_intervals,
                         read_count, reads, reps);
  }

error:
  free(buf);
  Py_XDECREF(chrom);
  Py_XDECREF(tint_intervals);
  Py_XDECREF(reads);
  Py_XDECREF(reps_dict);
  return NULL;
}

/* ---------------------------------------------------------------- segment
 * parse_segment_file(path) ->
 *   (tint_id, chrom, positions, rows, read_reps)
 *   rows: [(rid, name, chrom, strand, tint, data, gaps, softclip, poly)]
 *     data: [int per digit of the 012 string]
 *     gaps: {(j1, j2): size}; softclip: {"SSC"/"ESC": int};
 *     poly: {"SA"/"ST"/"EA"/"ST": (len, gap)}
 *   read_reps: [[row_idx, ...]] grouped by the reference's rep key
 *   (data with 2->0, bucketed internal gap sizes, polyA signature --
 *   py/freddie_cluster.py:154-164), first-seen order.
 *
 * The gaps field is our own writer's "tok,tok,...," form; any piece
 * that does not match one of the three token grammars exactly raises
 * ValueError, and the Python wrapper falls back to the regex parser
 * (which scans permissively), so results never depend on this parser.
 */

static int piece_is_digits(const char* s, const char* e) {
  if (s >= e) return 0;
  for (; s < e; ++s)
    if (*s < '0' || *s > '9') return 0;
  return 1;
}

static PyObject* parse_segment_file(PyObject* self, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return NULL;

  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return NULL;
  }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc((size_t)fsize + 1);
  if (!buf || fread(buf, 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    free(buf);
    PyErr_SetString(PyExc_OSError, "short read");
    return NULL;
  }
  fclose(f);
  buf[fsize] = '\n';

  PyObject* chrom = NULL;
  PyObject* positions = NULL;
  PyObject* rows = PyList_New(0);
  PyObject* reps_dict = PyDict_New();
  long long tint_id = -1;
  long long n_segs = -1;
  Py_ssize_t chrom_len = 0;
  const char* chrom_s = NULL;
  char keybuf_static[4096];

  if (!rows || !reps_dict) goto serror;

  const char* p = buf;
  const char* bend = buf + fsize;

#define SFAIL(msg)            \
  do {                        \
    fail_assert(msg);         \
    goto serror;              \
  } while (0)
#define SVFAIL(msg)                          \
  do {                                       \
    PyErr_SetString(PyExc_ValueError, msg);  \
    goto serror;                             \
  } while (0)

  while (p < bend) {
    const char* eol = memchr(p, '\n', (size_t)(bend - p + 1));
    if (!eol) eol = bend;
    const char* line = p;
    const char* lend = eol;
    p = eol + 1;
    if (line == lend) continue;

    if (*line == '#') {
      if (chrom != NULL) SFAIL("multiple tints in one segment file");
      const char* t1 = memchr(line, '\t', (size_t)(lend - line));
      if (!t1) SVFAIL("header: missing fields");
      chrom_s = line + 1;
      chrom_len = t1 - line - 1;
      chrom = PyUnicode_FromStringAndSize(chrom_s, chrom_len);
      if (!chrom) goto serror;
      const char* q = t1 + 1;
      tint_id = parse_ll(&q, lend);
      if (tint_id < 0 || q >= lend || *q != '\t') SVFAIL("header: bad tint");
      ++q;
      positions = PyList_New(0);
      if (!positions) goto serror;
      long long prev = -1;
      long long count = 0;
      while (1) {
        long long v = parse_ll(&q, lend);
        if (v < 0) SVFAIL("header: bad position");
        if (prev >= 0 && !(prev < v)) SFAIL("header: positions not ascending");
        prev = v;
        ++count;
        PyObject* pv = PyLong_FromLongLong(v);
        if (!pv || PyList_Append(positions, pv) < 0) {
          Py_XDECREF(pv);
          goto serror;
        }
        Py_DECREF(pv);
        if (q < lend && *q == ',') {
          ++q;
          continue;
        }
        break;
      }
      if (q != lend) SVFAIL("header: trailing junk");
      n_segs = count - 1;
      continue;
    }
    if (chrom == NULL) SFAIL("read row before tint header");

    /* rid \t name \t chrom \t strand \t tint \t data \t gaps */
    const char* q = line;
    long long rid = parse_ll(&q, lend);
    if (rid < 0 || q >= lend || *q != '\t') SVFAIL("row: bad rid");
    ++q;
    const char* t = memchr(q, '\t', (size_t)(lend - q));
    if (!t) SVFAIL("row: missing name end");
    PyObject* name = PyUnicode_FromStringAndSize(q, t - q);
    q = t + 1;
    t = memchr(q, '\t', (size_t)(lend - q));
    if (!t) {
      Py_XDECREF(name);
      SVFAIL("row: missing chrom end");
    }
    const char* rchrom_s = q;
    Py_ssize_t rchrom_len = t - q;
    PyObject* rchrom = PyUnicode_FromStringAndSize(q, t - q);
    q = t + 1;
    t = memchr(q, '\t', (size_t)(lend - q));
    if (!t) {
      Py_XDECREF(name);
      Py_XDECREF(rchrom);
      SVFAIL("row: missing strand end");
    }
    PyObject* strand = PyUnicode_FromStringAndSize(q, t - q);
    q = t + 1;
    long long rtint = parse_ll(&q, lend);
    if (rtint < 0 || q >= lend || *q != '\t') {
      Py_XDECREF(name);
      Py_XDECREF(rchrom);
      Py_XDECREF(strand);
      SVFAIL("row: bad tint");
    }
    ++q;
    const char* data_s = q;
    t = memchr(q, '\t', (size_t)(lend - q));
    const char* data_e = t ? t : lend;
    const char* gaps_s = t ? t + 1 : lend;
    const char* gaps_e = lend;
    /* gaps may themselves contain no tabs in this wire format; anything
     * after another tab is not produced by the writer */
    if (t && memchr(gaps_s, '\t', (size_t)(lend - gaps_s))) {
      Py_XDECREF(name);
      Py_XDECREF(rchrom);
      Py_XDECREF(strand);
      SVFAIL("row: unexpected extra fields");
    }
    long long dlen = data_e - data_s;
    if (n_segs >= 0 && dlen != n_segs) {
      Py_XDECREF(name);
      Py_XDECREF(rchrom);
      Py_XDECREF(strand);
      SFAIL("row: data length != segment count");
    }
    if (!(rchrom_len == chrom_len && memcmp(rchrom_s, chrom_s, chrom_len) == 0)) {
      Py_XDECREF(name);
      Py_XDECREF(rchrom);
      Py_XDECREF(strand);
      SFAIL("row: chrom mismatch");
    }

    PyObject* data = PyList_New(dlen);
    PyObject* gaps = PyDict_New();
    PyObject* softclip = PyDict_New();
    PyObject* poly = PyDict_New();
    char* key = keybuf_static;
    size_t key_cap = sizeof(keybuf_static);
    size_t key_len = 0;
    char* key_heap = NULL;
    if (!data || !gaps || !softclip || !poly) goto row_err;

#define KEY_RESERVE(extra)                                   \
  do {                                                       \
    if (key_len + (extra) + 1 > key_cap) {                   \
      size_t nc = key_cap * 2 + (extra);                     \
      char* nk = (char*)malloc(nc);                          \
      if (!nk) goto row_err;                                 \
      memcpy(nk, key, key_len);                              \
      if (key_heap) free(key_heap);                          \
      key_heap = nk;                                         \
      key = nk;                                              \
      key_cap = nc;                                          \
    }                                                        \
  } while (0)

    KEY_RESERVE((size_t)dlen);
    for (long long i = 0; i < dlen; ++i) {
      char c = data_s[i];
      if (c < '0' || c > '9') goto row_vfail;
      PyObject* dv = PyLong_FromLong(c - '0');
      if (!dv) goto row_err;
      PyList_SET_ITEM(data, i, dv);
      key[key_len++] = (c == '2') ? '0' : c;
    }

    /* gap tokens: tok followed by ',' each */
    {
      const char* g = gaps_s;
      while (g < gaps_e) {
        const char* ge = memchr(g, ',', (size_t)(gaps_e - g));
        if (!ge) goto row_vfail; /* no trailing comma: let Python decide */
        /* classify the piece [g, ge) */
        const char* colon = memchr(g, ':', (size_t)(ge - g));
        if (!colon) goto row_vfail;
        if (!piece_is_digits(colon + 1, ge)) goto row_vfail;
        const char* vq = colon + 1;
        long long val = parse_ll(&vq, ge);
        if (val < 0 || vq != ge) goto row_vfail;
        Py_ssize_t head = colon - g;
        const char* dash = memchr(g, '-', (size_t)head);
        const char* under = memchr(g, '_', (size_t)head);
        if (dash && piece_is_digits(g, dash) &&
            piece_is_digits(dash + 1, colon)) {
          /* internal gap j1-j2:size */
          const char* aq = g;
          long long a = parse_ll(&aq, dash);
          const char* bq = dash + 1;
          long long b = parse_ll(&bq, colon);
          if (a < 0 || b < 0) goto row_vfail;
          if (!(0 <= a && a < b && b < dlen)) goto row_fail_bounds;
          PyObject* kk = Py_BuildValue("(LL)", a, b);
          PyObject* vv = PyLong_FromLongLong(val);
          if (!kk || !vv || PyDict_SetItem(gaps, kk, vv) < 0) {
            Py_XDECREF(kk);
            Py_XDECREF(vv);
            goto row_err;
          }
          Py_DECREF(kk);
          Py_DECREF(vv);
          /* key piece: ".size" if > 10 else ".0" */
          if (val > 10) {
            char tmp[32];
            int nn = snprintf(tmp, sizeof(tmp), ".%.*s",
                              (int)(ge - (colon + 1)), colon + 1);
            KEY_RESERVE((size_t)nn);
            memcpy(key + key_len, tmp, (size_t)nn);
            key_len += (size_t)nn;
          } else {
            KEY_RESERVE(2);
            key[key_len++] = '.';
            key[key_len++] = '0';
          }
        } else if (head == 3 && (g[0] == 'E' || g[0] == 'S') && g[1] == 'S' &&
                   g[2] == 'C') {
          PyObject* kk = PyUnicode_FromStringAndSize(g, 3);
          PyObject* vv = PyLong_FromLongLong(val);
          if (!kk || !vv || PyDict_SetItem(softclip, kk, vv) < 0) {
            Py_XDECREF(kk);
            Py_XDECREF(vv);
            goto row_err;
          }
          Py_DECREF(kk);
          Py_DECREF(vv);
        } else if (under && under - g == 2 && (g[0] == 'E' || g[0] == 'S') &&
                   (g[1] == 'A' || g[1] == 'T') &&
                   piece_is_digits(under + 1, colon)) {
          /* poly token XY_len:gap */
          const char* lq = under + 1;
          long long plen = parse_ll(&lq, colon);
          if (plen < 0) goto row_vfail;
          PyObject* kk = PyUnicode_FromStringAndSize(g, 2);
          PyObject* vv = Py_BuildValue("(LL)", plen, val);
          if (!kk || !vv || PyDict_SetItem(poly, kk, vv) < 0) {
            Py_XDECREF(kk);
            Py_XDECREF(vv);
            goto row_err;
          }
          Py_DECREF(kk);
          Py_DECREF(vv);
          /* key piece: ".{side}{gap if > 10 else 0}" */
          if (val > 10) {
            char tmp[40];
            int nn = snprintf(tmp, sizeof(tmp), ".%c%.*s", g[0],
                              (int)(ge - (colon + 1)), colon + 1);
            KEY_RESERVE((size_t)nn);
            memcpy(key + key_len, tmp, (size_t)nn);
            key_len += (size_t)nn;
          } else {
            KEY_RESERVE(3);
            key[key_len++] = '.';
            key[key_len++] = g[0];
            key[key_len++] = '0';
          }
        } else {
          goto row_vfail; /* unknown token shape: Python decides */
        }
        g = ge + 1;
      }
    }

    {
      PyObject* row = Py_BuildValue("(LNNNLNNNN)", rid, name, rchrom, strand,
                                    rtint, data, gaps, softclip, poly);
      if (!row || PyList_Append(rows, row) < 0) {
        Py_XDECREF(row);
        if (key_heap) free(key_heap);
        goto serror;
      }
      Py_DECREF(row);
    }
    {
      PyObject* key_obj = PyUnicode_FromStringAndSize(key, (Py_ssize_t)key_len);
      if (key_heap) free(key_heap);
      key_heap = NULL;
      if (!key_obj) goto serror;
      PyObject* lst = PyDict_GetItem(reps_dict, key_obj);
      if (!lst) {
        PyObject* fresh = PyList_New(0);
        if (!fresh || PyDict_SetItem(reps_dict, key_obj, fresh) < 0) {
          Py_XDECREF(fresh);
          Py_DECREF(key_obj);
          goto serror;
        }
        Py_DECREF(fresh);
        lst = PyDict_GetItem(reps_dict, key_obj);
      }
      Py_DECREF(key_obj);
      PyObject* idx = PyLong_FromSsize_t(PyList_GET_SIZE(rows) - 1);
      if (!idx || !lst || PyList_Append(lst, idx) < 0) {
        Py_XDECREF(idx);
        goto serror;
      }
      Py_DECREF(idx);
    }
    continue;

  row_fail_bounds:
    fail_assert("row: gap bounds out of range");
    goto row_err;
  row_vfail:
    PyErr_SetString(PyExc_ValueError, "row: unparseable field");
  row_err:
    Py_XDECREF(name);
    Py_XDECREF(rchrom);
    Py_XDECREF(strand);
    Py_XDECREF(data);
    Py_XDECREF(gaps);
    Py_XDECREF(softclip);
    Py_XDECREF(poly);
    if (key_heap) free(key_heap);
    goto serror;
  }

  if (chrom == NULL) SFAIL("no tint header");
  {
    PyObject* reps = PyList_New(0);
    if (!reps) goto serror;
    Py_ssize_t dpos = 0;
    PyObject *dk, *dv;
    while (PyDict_Next(reps_dict, &dpos, &dk, &dv)) {
      if (PyList_Append(reps, dv) < 0) {
        Py_DECREF(reps);
        goto serror;
      }
    }
    Py_DECREF(reps_dict);
    free(buf);
    return Py_BuildValue("(LNNNN)", tint_id, chrom, positions, rows, reps);
  }

serror:
  free(buf);
  Py_XDECREF(chrom);
  Py_XDECREF(positions);
  Py_XDECREF(rows);
  Py_XDECREF(reps_dict);
  return NULL;
}

/* ------------------------------------------------------------------ reads
 * load_reads_seqs(path) -> {read_id: seq}
 *
 * Native twin of freddie_jax/io/tsv.py:load_read_sequences's dict-building
 * loop (wire format: split stage's reads_{contig}_{tint}.tsv rows
 * "id \t chrom \t tint \t seq"). Matches the Python semantics exactly:
 * field 3 is the text between the 3rd tab and the 4th tab or line end
 * (the line's sole '\n' already consumed by the line scan), duplicate ids
 * keep the last occurrence, text decodes as UTF-8. Malformed rows raise
 * ValueError; the Python wrapper falls back to its own loop so error
 * behavior never depends on the toolchain. */
static PyObject* load_reads_seqs(PyObject* self, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return NULL;

  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return NULL;
  }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc((size_t)fsize + 1);
  if (!buf || fread(buf, 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    free(buf);
    PyErr_SetString(PyExc_OSError, "short read");
    return NULL;
  }
  fclose(f);
  buf[fsize] = '\n';

  PyObject* out = PyDict_New();
  if (!out) {
    free(buf);
    return NULL;
  }
  const char* p = buf;
  const char* bend = buf + fsize;
  while (p < bend) {
    const char* eol = memchr(p, '\n', (size_t)(bend - p + 1));
    if (!eol) eol = bend;
    const char* line = p;
    const char* lend = eol;
    p = eol + 1;
    if (line == lend) continue; /* blank, like ''.split() would KeyError
                                   in Python -- but Python iterates lines
                                   from open(), which never yields '' */
    const char* q = line;
    long long rid = parse_ll(&q, lend);
    if (rid < 0 || q >= lend || *q != '\t') goto bad;
    /* skip to the 3rd tab */
    const char* t = q;
    for (int k = 0; k < 2; ++k) {
      t = memchr(t + 1, '\t', (size_t)(lend - t - 1));
      if (!t) goto bad;
    }
    const char* seq_s = t + 1;
    const char* t4 = memchr(seq_s, '\t', (size_t)(lend - seq_s));
    const char* seq_e = t4 ? t4 : lend;
    {
      PyObject* key = PyLong_FromLongLong(rid);
      PyObject* val =
          PyUnicode_DecodeUTF8(seq_s, (Py_ssize_t)(seq_e - seq_s), NULL);
      if (!key || !val || PyDict_SetItem(out, key, val) < 0) {
        Py_XDECREF(key);
        Py_XDECREF(val);
        goto err;
      }
      Py_DECREF(key);
      Py_DECREF(val);
    }
  }
  free(buf);
  return out;

bad:
  PyErr_SetString(PyExc_ValueError, "reads tsv: malformed row");
err:
  free(buf);
  Py_DECREF(out);
  return NULL;
}

static PyMethodDef Methods[] = {
    {"parse_split_file", parse_split_file, METH_VARARGS,
     "Parse one split TSV into (chrom, tint, intervals, n_reads, reads)."},
    {"parse_segment_file", parse_segment_file, METH_VARARGS,
     "Parse one segment TSV into (tint, chrom, positions, rows, reps)."},
    {"load_reads_seqs", load_reads_seqs, METH_VARARGS,
     "Parse one reads TSV into {read_id: seq}."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "tsvparse",
                                       NULL, -1, Methods};

PyMODINIT_FUNC PyInit_tsvparse(void) { return PyModule_Create(&moduledef); }
