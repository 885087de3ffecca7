/* CPython extension: per-read clip context + gap/polyA token emission.
 *
 * Native twin of freddie_jax/ops/polya.py's clip_context and emit_tokens
 * (reference semantics: py/freddie_segment.py:289-349 target->query
 * mapping, :370-472 token emission). The Python implementations remain
 * the semantic oracles and transparent fallbacks; tests fuzz the two
 * against each other read-for-read.
 *
 * clip_context(data, segs, intervals, read_len)
 *   -> None when no segment is covered, else (q_ssc, q_esc, runs)
 *      with runs = [(first, last), ...] maximal runs of 1s in data.
 * emit_tokens(q_ssc, q_esc, runs, best_s, best_e, segs, intervals,
 *             read_len)
 *   -> sorted list of token strings; best_s/best_e are None or
 *      (offset, length, char) like the Python twin.
 *
 * CIGAR op codes follow io.bam: M=0 I=1 D=2 N=3 S=4 H=5 P=6 ==7 X=8.
 * Every assert of the Python twins is replicated as AssertionError.
 *
 * Build: gcc -O2 -shared -fPIC -I<python-include> -o polyatok.so polyatok.c
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdio.h>
#include <string.h>

#define OP_M 0
#define OP_I 1
#define OP_D 2
#define OP_EQ 7
#define OP_X 8

static int fail(const char* msg) {
  PyErr_SetString(PyExc_AssertionError, msg);
  return -1;
}

/* Walk one interval's cigar to target position t_goal (>= t_start),
 * returning the aligned query position. -1 with exception set on error. */
static long long walk_cigar_to(PyObject* cigar, long long t_goal,
                               long long t_pos, long long q_pos) {
  if (t_pos > t_goal) return fail("walk: t_pos > t_goal");
  Py_ssize_t n = PyList_GET_SIZE(cigar);
  Py_ssize_t i = 0;
  while (t_pos < t_goal) {
    if (i >= n) return fail("walk: cigar exhausted");
    PyObject* el = PyList_GET_ITEM(cigar, i); /* (op, len) */
    long long op = PyLong_AsLongLong(PyTuple_GET_ITEM(el, 0));
    long long c = PyLong_AsLongLong(PyTuple_GET_ITEM(el, 1));
    if (PyErr_Occurred()) return -1;
    /* The Python twin clamps EVERY op by the remaining target distance,
     * including insertions (walk_cigar_to's c = min(c, t_goal - t_pos)
     * before the op dispatch) -- a quirk that shapes q_pos and must be
     * replicated exactly. */
    if (c > t_goal - t_pos) c = t_goal - t_pos;
    if (op == OP_M || op == OP_EQ || op == OP_X) {
      t_pos += c;
      q_pos += c;
    } else if (op == OP_D) {
      t_pos += c;
    } else if (op == OP_I) {
      q_pos += c;
    }
    ++i;
  }
  if (t_pos != t_goal) return fail("walk: t_pos != t_goal");
  return q_pos;
}

/* First query position aligned at/after target `start`; *slack <= 0. */
static int query_pos_at_start(long long start, PyObject* intervals,
                              long long* q_out, long long* slack_out) {
  Py_ssize_t n = PyList_GET_SIZE(intervals);
  for (Py_ssize_t idx = 0; idx < n; ++idx) {
    PyObject* iv = PyList_GET_ITEM(intervals, idx);
    long long ts = PyLong_AsLongLong(PyTuple_GET_ITEM(iv, 0));
    long long te = PyLong_AsLongLong(PyTuple_GET_ITEM(iv, 1));
    long long qs = PyLong_AsLongLong(PyTuple_GET_ITEM(iv, 2));
    long long qe = PyLong_AsLongLong(PyTuple_GET_ITEM(iv, 3));
    if (PyErr_Occurred()) return -1;
    if (te < start) continue;
    long long q_pos, slack;
    if (start < ts) {
      q_pos = qs;
      slack = start - ts;
    } else {
      q_pos = walk_cigar_to(PyTuple_GET_ITEM(iv, 4), start, ts, qs);
      if (q_pos < 0 && PyErr_Occurred()) return -1;
      slack = 0;
    }
    if (slack > 0) return fail("start: slack > 0");
    if (!(qs <= q_pos && q_pos <= qe)) return fail("start: q_pos outside");
    *q_out = q_pos;
    *slack_out = slack;
    return 0;
  }
  return fail("no interval reaches start");
}

/* Last query position aligned at/before target `end`. */
static int query_pos_at_end(long long end, PyObject* intervals,
                            long long* q_out, long long* slack_out) {
  Py_ssize_t n = PyList_GET_SIZE(intervals);
  for (Py_ssize_t idx = n - 1; idx >= 0; --idx) {
    PyObject* iv = PyList_GET_ITEM(intervals, idx);
    long long ts = PyLong_AsLongLong(PyTuple_GET_ITEM(iv, 0));
    long long te = PyLong_AsLongLong(PyTuple_GET_ITEM(iv, 1));
    long long qs = PyLong_AsLongLong(PyTuple_GET_ITEM(iv, 2));
    long long qe = PyLong_AsLongLong(PyTuple_GET_ITEM(iv, 3));
    if (PyErr_Occurred()) return -1;
    if (ts > end) continue;
    long long q_pos, slack;
    if (te < end) {
      q_pos = qe;
      slack = te - end;
    } else {
      q_pos = walk_cigar_to(PyTuple_GET_ITEM(iv, 4), end, ts, qs);
      if (q_pos < 0 && PyErr_Occurred()) return -1;
      slack = 0;
    }
    if (slack > 0) return fail("end: slack > 0");
    if (!(0 <= q_pos && q_pos <= qe)) return fail("end: q_pos outside");
    *q_out = q_pos;
    *slack_out = slack;
    return 0;
  }
  return fail("no interval reaches end");
}

static PyObject* clip_context(PyObject* self, PyObject* args) {
  PyObject *data, *segs, *intervals;
  long long read_len;
  if (!PyArg_ParseTuple(args, "O!O!O!L", &PyList_Type, &data, &PyList_Type,
                        &segs, &PyList_Type, &intervals, &read_len))
    return NULL;

  Py_ssize_t n = PyList_GET_SIZE(data);
  PyObject* runs = PyList_New(0);
  if (!runs) return NULL;
  long long run_start = -1;
  long long first_run_start = -1, last_run_end = -1;
  for (Py_ssize_t i = 0; i < n; ++i) {
    long long d = PyLong_AsLongLong(PyList_GET_ITEM(data, i));
    if (PyErr_Occurred()) {
      Py_DECREF(runs);
      return NULL;
    }
    if (d == 1) {
      if (run_start < 0) run_start = i;
    } else if (run_start >= 0) {
      PyObject* r = Py_BuildValue("(LL)", run_start, (long long)(i - 1));
      if (!r || PyList_Append(runs, r) < 0) {
        Py_XDECREF(r);
        Py_DECREF(runs);
        return NULL;
      }
      Py_DECREF(r);
      if (first_run_start < 0) first_run_start = run_start;
      last_run_end = i - 1;
      run_start = -1;
    }
  }
  if (run_start >= 0) {
    PyObject* r = Py_BuildValue("(LL)", run_start, (long long)(n - 1));
    if (!r || PyList_Append(runs, r) < 0) {
      Py_XDECREF(r);
      Py_DECREF(runs);
      return NULL;
    }
    Py_DECREF(r);
    if (first_run_start < 0) first_run_start = run_start;
    last_run_end = n - 1;
  }
  if (PyList_GET_SIZE(runs) == 0) {
    Py_DECREF(runs);
    Py_RETURN_NONE; /* 1 not in data */
  }

  PyObject* seg_f = PyList_GET_ITEM(segs, first_run_start);
  long long start = PyLong_AsLongLong(PyTuple_GET_ITEM(seg_f, 0));
  PyObject* seg_l = PyList_GET_ITEM(segs, last_run_end);
  long long end = PyLong_AsLongLong(PyTuple_GET_ITEM(seg_l, 1));
  if (PyErr_Occurred()) {
    Py_DECREF(runs);
    return NULL;
  }
  long long q_ssc, q_esc, slack;
  if (query_pos_at_start(start, intervals, &q_ssc, &slack) < 0 ||
      query_pos_at_end(end, intervals, &q_esc, &slack) < 0) {
    Py_DECREF(runs);
    return NULL;
  }
  if (!(0 <= q_ssc && q_ssc <= q_esc && q_esc <= read_len)) {
    Py_DECREF(runs);
    fail("clip: q_ssc/q_esc out of order");
    return NULL;
  }
  return Py_BuildValue("(LLN)", q_ssc, q_esc, runs);
}

static PyObject* emit_tokens(PyObject* self, PyObject* args) {
  long long q_ssc, q_esc, read_len;
  PyObject *runs, *best_s, *best_e, *segs, *intervals;
  if (!PyArg_ParseTuple(args, "LLO!OOO!O!L", &q_ssc, &q_esc, &PyList_Type,
                        &runs, &best_s, &best_e, &PyList_Type, &segs,
                        &PyList_Type, &intervals, &read_len))
    return NULL;

  PyObject* out = PyList_New(0);
  if (!out) return NULL;
  char buf[96];

#define EMIT(...)                                              \
  do {                                                         \
    snprintf(buf, sizeof(buf), __VA_ARGS__);                   \
    PyObject* s_ = PyUnicode_FromString(buf);                  \
    if (!s_ || PyList_Append(out, s_) < 0) {                   \
      Py_XDECREF(s_);                                          \
      goto error;                                              \
    }                                                          \
    Py_DECREF(s_);                                             \
  } while (0)

  if (best_s != Py_None) {
    long long i = PyLong_AsLongLong(PyTuple_GET_ITEM(best_s, 0));
    long long l = PyLong_AsLongLong(PyTuple_GET_ITEM(best_s, 1));
    PyObject* ch = PyTuple_GET_ITEM(best_s, 2);
    const char* c = PyUnicode_AsUTF8(ch);
    if (PyErr_Occurred() || !c) goto error;
    long long gap = q_ssc - i - l;
    if (!(0 <= gap && gap < q_ssc)) {
      fail("emit: start gap out of range");
      goto error;
    }
    EMIT("S%s_%lld:%lld", c, l, gap);
    EMIT("SSC:%lld", i);
  } else {
    EMIT("SSC:%lld", q_ssc);
  }

  if (best_e != Py_None) {
    long long i = PyLong_AsLongLong(PyTuple_GET_ITEM(best_e, 0));
    long long l = PyLong_AsLongLong(PyTuple_GET_ITEM(best_e, 1));
    PyObject* ch = PyTuple_GET_ITEM(best_e, 2);
    const char* c = PyUnicode_AsUTF8(ch);
    if (PyErr_Occurred() || !c) goto error;
    long long gap = i;
    if (!(0 <= gap && gap < read_len - q_esc)) {
      fail("emit: end gap out of range");
      goto error;
    }
    if (!(read_len - q_esc - gap > 0)) {
      fail("emit: nonpositive ESC");
      goto error;
    }
    EMIT("E%s_%lld:%lld", c, l, gap);
    EMIT("ESC:%lld", read_len - q_esc - gap);
  } else {
    EMIT("ESC:%lld", read_len - q_esc);
  }

  Py_ssize_t n_runs = PyList_GET_SIZE(runs);
  for (Py_ssize_t r = 0; r + 1 < n_runs; ++r) {
    PyObject* r1 = PyList_GET_ITEM(runs, r);
    PyObject* r2 = PyList_GET_ITEM(runs, r + 1);
    long long r1_l = PyLong_AsLongLong(PyTuple_GET_ITEM(r1, 1));
    long long r2_f = PyLong_AsLongLong(PyTuple_GET_ITEM(r2, 0));
    if (PyErr_Occurred()) goto error;
    PyObject* seg1 = PyList_GET_ITEM(segs, r1_l);
    PyObject* seg2 = PyList_GET_ITEM(segs, r2_f);
    long long end1 = PyLong_AsLongLong(PyTuple_GET_ITEM(seg1, 1));
    long long start2 = PyLong_AsLongLong(PyTuple_GET_ITEM(seg2, 0));
    if (PyErr_Occurred()) goto error;
    long long g_start, g_end, s_slack, e_slack;
    if (query_pos_at_end(end1, intervals, &g_start, &s_slack) < 0) goto error;
    if (query_pos_at_start(start2, intervals, &g_end, &e_slack) < 0)
      goto error;
    if (!(0 < g_start && g_start <= g_end && g_end < read_len)) {
      fail("emit: gap bounds out of order");
      goto error;
    }
    long long size = g_end - g_start + s_slack + e_slack;
    if (size < 0) size = 0;
    if (!(0 <= size && size < read_len)) {
      fail("emit: gap size out of range");
      goto error;
    }
    if (!(r1_l < r2_f)) {
      fail("emit: runs out of order");
      goto error;
    }
    EMIT("%lld-%lld:%lld", r1_l, r2_f, size);
  }
#undef EMIT

  if (PyList_Sort(out) < 0) goto error;
  return out;

error:
  Py_DECREF(out);
  return NULL;
}

/* Best polyA/polyT run in one soft-clip window -- C twin of the Kadane
 * scorer (ops/polya.py longest_poly_runs + the per-window selection;
 * same contract as ops/polya_batch._scan_np for one row).
 *
 * best_run(seq, lo, hi, minus, char) -> None | (first, length, cnt)
 *   Window w[t] = seq[lo+t] ('+') or seq[L-1-lo-t] ('-', scanning the
 *   mirrored slice reversed); the scan char is complemented on '-'.
 *   Kadane score s_t = max(0, s_{t-1} + (match ? +1 : -2)); each maximal
 *   positive stretch is a run whose extent ends at its best-scoring
 *   position (ties -> latest, the reference's max(zip(S, i))); runs
 *   qualify at length >= 20 and 20*cnt >= 17*length (exactly the
 *   purity >= 0.85 rational test; equals the host's float compare, see
 *   _scan_np's docstring); the winner maximizes purity = cnt/length in
 *   double with the EARLIEST run winning ties (sequential strict
 *   update). Offsets are window-relative in alignment orientation. */
static PyObject* best_run(PyObject* self, PyObject* args) {
  const char* seq;
  Py_ssize_t seq_len;
  long long lo, hi;
  int minus;
  const char* ch;
  Py_ssize_t ch_len;
  if (!PyArg_ParseTuple(args, "s#LLis#", &seq, &seq_len, &lo, &hi, &minus,
                        &ch, &ch_len))
    return NULL;
  if (ch_len != 1) {
    PyErr_SetString(PyExc_ValueError, "char must be one character");
    return NULL;
  }
  char target = ch[0];
  if (minus) {
    switch (target) {
      case 'A': target = 'T'; break;
      case 'T': target = 'A'; break;
      case 'C': target = 'G'; break;
      case 'G': target = 'C'; break;
      default: break;
    }
  }
  const long long L = (long long)seq_len;
  const long long W = hi - lo;
  long long best_first = -1, best_len = 0, best_cnt = 0;
  double best_purity = -1.0;

  long long score = 0;
  long long run_first = -1, run_cnt = 0;
  long long best_score = -1, best_t = -1, cnt_at_best = 0;
#define FINISH_RUN()                                                       \
  do {                                                                     \
    if (run_first >= 0) {                                                  \
      long long length = best_t + 1 - run_first;                           \
      if (length >= 20 && 20 * cnt_at_best >= 17 * length) {               \
        double p = (double)cnt_at_best / (double)length;                   \
        if (p > best_purity) {                                             \
          best_purity = p;                                                 \
          best_first = run_first;                                          \
          best_len = length;                                               \
          best_cnt = cnt_at_best;                                          \
        }                                                                  \
      }                                                                    \
      run_first = -1;                                                      \
    }                                                                      \
  } while (0)

  for (long long t = 0; t < W; ++t) {
    long long idx = minus ? (L - 1 - lo - t) : (lo + t);
    int m = (idx >= 0 && idx < L && seq[idx] == target);
    score += m ? 1 : -2;
    if (score < 0) score = 0;
    if (score > 0) {
      if (run_first < 0) {
        run_first = t;
        run_cnt = 0;
        best_score = -1;
        best_t = -1;
        cnt_at_best = 0;
      }
      if (m) ++run_cnt;
      if (score >= best_score) { /* ties -> latest position */
        best_score = score;
        best_t = t;
        cnt_at_best = run_cnt;
      }
    } else {
      FINISH_RUN();
    }
  }
  FINISH_RUN();
#undef FINISH_RUN
  if (best_first < 0) Py_RETURN_NONE;
  return Py_BuildValue("(LLL)", best_first, best_len, best_cnt);
}

static PyMethodDef Methods[] = {
    {"clip_context", clip_context, METH_VARARGS,
     "Covered-run structure of one read."},
    {"emit_tokens", emit_tokens, METH_VARARGS,
     "Token list from a clip context and resolved polyA candidates."},
    {"best_run", best_run, METH_VARARGS,
     "Best qualifying polyA/T run in one soft-clip window."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "polyatok",
                                       NULL, -1, Methods};

PyMODINIT_FUNC PyInit_polyatok(void) { return PyModule_Create(&moduledef); }
