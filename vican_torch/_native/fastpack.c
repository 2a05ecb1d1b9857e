/* fastpack — C packing kernel for the edge-dict host boundary.
 *
 * The reference spends its host time in Python dict loops
 * (vican/bipgo.py:203-223, 445-469); our solver needs the same boundary
 * crossed once per solve: filter edges, parse "<t>_<marker>" keys, build
 * node-index maps, convert rotations to quaternions (the compact device
 * transfer format — 4 floats/edge instead of 9 over the bandwidth-bound
 * host link), and fill the fused per-edge buffers the device program
 * consumes in TWO H2D transfers:
 *
 *   edata (E, 9)  [qw qx qy qz | tx ty tz | k_r k_t]   float32/float64
 *   eidx  (E, 3)  [cam, time, marker]                  int32
 *
 * Everything is a single pass over the dict; only the user-supplied
 * callables (edge_filter, noise_model_r/t — arbitrary Python, main.ipynb
 * cells 3/7) are invoked through the interpreter.  The orthonormality /
 * properness gate for the quaternion transfer runs over EVERY edge here
 * (in doubles) at no extra pass.
 *
 * Exposed as vican_torch._native.fastpack.pack_edges2()/pack_edges3(); the
 * pure-Python fallback lives in vican_torch/solver/packing.py and produces
 * identical output (tests/test_torch_packing.py).  This file is a copy of
 * vican_tpu/_native/fastpack.c, which the JAX package builds the same way.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

/* numpy C-API: direct data access for the per-edge pose/corners arrays —
 * the buffer-protocol export (PyObject_GetBuffer) costs ~10x more per call
 * than PyArray_DATA on an already-checked ndarray.  Non-ndarray inputs keep
 * the buffer-protocol path (exact same reads). */
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

/* Intern a node id string into (map, list); returns its index or -1. */
static long intern_id(PyObject *map, PyObject *list, PyObject *s) {
    PyObject *pv = PyDict_GetItemWithError(map, s); /* borrowed */
    if (pv != NULL) return PyLong_AsLong(pv);
    if (PyErr_Occurred()) return -1;
    long idx = (long)PyList_GET_SIZE(list);
    if (PyList_Append(list, s) < 0) return -1;
    pv = PyLong_FromLong(idx);
    if (pv == NULL) return -1;
    int bad = PyDict_SetItem(map, s, pv);
    Py_DECREF(pv);
    return bad ? -1 : idx;
}

/* Recognized-form evaluation (the packing fast path).
 *
 * The Python layer (solver/specs.py) recognizes the canonical noise-model /
 * edge-filter shapes — `scale * polygon_area(e["corners"]) ** power`,
 * constants, `e["reprojected_err"] < tau` — by spec type or sound bytecode
 * template matching, and passes them down as spec tuples so this kernel
 * evaluates them inline: zero interpreter round-trips per edge.  The
 * arithmetic replicates the Python closure operation-for-operation (the
 * shoelace term order of ops/shoelace.py's scalar path; libm pow; double
 * compares), so the outputs are bit-identical to calling the closure —
 * pinned by tests/test_torch_packing.py.  Any per-edge surprise (corners not a
 * contiguous (4,2) f32/f64 buffer, missing key) falls back to calling the
 * original callable for THAT edge, preserving exact semantics. */
typedef struct {
    int mode;       /* noise: 0 call, 1 const, 2 area_pow
                     * filter: 0 call, 1 keep-all, 2 reproj_lt */
    double a, b;    /* const c / (scale, power) / tau */
    PyObject *call; /* the original callable (fallback + mode 0) */
} espec;

static int parse_spec(PyObject *obj, PyObject *call, espec *sp, int is_filter) {
    sp->mode = 0;
    sp->a = 0.0;
    sp->b = 0.0;
    sp->call = call;
    if (obj == NULL || obj == Py_None) return 0;
    if (PyTuple_Check(obj) && PyTuple_GET_SIZE(obj) >= 1 &&
        PyUnicode_Check(PyTuple_GET_ITEM(obj, 0))) {
        const char *s = PyUnicode_AsUTF8(PyTuple_GET_ITEM(obj, 0));
        if (s == NULL) return -1;
        Py_ssize_t sz = PyTuple_GET_SIZE(obj);
        if (is_filter && strcmp(s, "true") == 0 && sz == 1) {
            sp->mode = 1;
            return 0;
        }
        if (is_filter && strcmp(s, "reproj_lt") == 0 && sz == 2) {
            sp->a = PyFloat_AsDouble(PyTuple_GET_ITEM(obj, 1));
            if (sp->a == -1.0 && PyErr_Occurred()) return -1;
            sp->mode = 2;
            return 0;
        }
        if (!is_filter && strcmp(s, "const") == 0 && sz == 2) {
            sp->a = PyFloat_AsDouble(PyTuple_GET_ITEM(obj, 1));
            if (sp->a == -1.0 && PyErr_Occurred()) return -1;
            sp->mode = 1;
            return 0;
        }
        if (!is_filter && strcmp(s, "area_pow") == 0 && sz == 3) {
            sp->a = PyFloat_AsDouble(PyTuple_GET_ITEM(obj, 1));
            if (sp->a == -1.0 && PyErr_Occurred()) return -1;
            sp->b = PyFloat_AsDouble(PyTuple_GET_ITEM(obj, 2));
            if (sp->b == -1.0 && PyErr_Occurred()) return -1;
            sp->mode = 2;
            return 0;
        }
    }
    PyErr_Format(PyExc_ValueError, "unrecognized packer spec: %R", obj);
    return -1;
}

/* Read an (n0, n1) C-contiguous f32/f64 array into doubles.
 * 1 = read, 0 = not that shape/type (caller falls back), no error set. */
static int read_f2d(PyObject *obj, Py_ssize_t n0, Py_ssize_t n1, double *out) {
    if (PyArray_Check(obj)) {
        PyArrayObject *ap = (PyArrayObject *)obj;
        if (PyArray_NDIM(ap) == 2 && PyArray_DIM(ap, 0) == n0 &&
            PyArray_DIM(ap, 1) == n1 && PyArray_IS_C_CONTIGUOUS(ap)) {
            int t = PyArray_TYPE(ap);
            if (t == NPY_FLOAT32) {
                const float *p = (const float *)PyArray_DATA(ap);
                for (Py_ssize_t i = 0; i < n0 * n1; i++) out[i] = (double)p[i];
                return 1;
            }
            if (t == NPY_FLOAT64) {
                memcpy(out, PyArray_DATA(ap), n0 * n1 * sizeof(double));
                return 1;
            }
        }
        return 0;
    }
    Py_buffer b;
    if (PyObject_GetBuffer(obj, &b, PyBUF_FORMAT | PyBUF_ND) < 0) {
        PyErr_Clear();
        return 0;
    }
    int ok = b.ndim == 2 && b.shape[0] == n0 && b.shape[1] == n1 &&
             b.buf != NULL && b.format != NULL;
    if (ok && b.format[0] == 'f' && b.format[1] == 0) {
        const float *p = (const float *)b.buf;
        for (Py_ssize_t i = 0; i < n0 * n1; i++) out[i] = (double)p[i];
    } else if (ok && b.format[0] == 'd' && b.format[1] == 0) {
        memcpy(out, b.buf, n0 * n1 * sizeof(double));
    } else {
        ok = 0;
    }
    PyBuffer_Release(&b);
    return ok;
}

/* scale * shoelace_area(corners)**power with the EXACT term order of
 * ops/shoelace.polygon_area's (4,2) scalar path; -1 with an error set on
 * failure, 1 on success, 0 when the value shape is unexpected (caller
 * falls back to the Python callable). */
static int area_pow_eval(PyObject *value, PyObject *corners_key, double scale,
                         double power, double *out) {
    PyObject *corners = PyDict_GetItemWithError(value, corners_key);
    if (corners == NULL) return PyErr_Occurred() ? -1 : 0;
    double c[8];
    if (!read_f2d(corners, 4, 2, c)) return 0;
    double t = c[0] * c[3] - c[2] * c[1]; /* x0*y1 - x1*y0 */
    t += c[2] * c[5];                     /* + x1*y2 */
    t -= c[4] * c[3];                     /* - x2*y1 */
    t += c[4] * c[7];                     /* + x2*y3 */
    t -= c[6] * c[5];                     /* - x3*y2 */
    t += c[6] * c[1];                     /* + x3*y0 */
    t -= c[0] * c[7];                     /* - x0*y3 */
    *out = scale * pow(0.5 * fabs(t), power);
    return 1;
}

static int noise_eval(espec *sp, PyObject *value, PyObject *corners_key,
                      double *out) {
    if (sp->mode == 1) {
        *out = sp->a;
        return 0;
    }
    if (sp->mode == 2) {
        int r = area_pow_eval(value, corners_key, sp->a, sp->b, out);
        if (r < 0) return -1;
        if (r == 1) return 0;
        /* unexpected corners value: exact per-edge fallback */
    }
    PyObject *obj = PyObject_CallOneArg(sp->call, value);
    if (obj == NULL) return -1;
    *out = PyFloat_AsDouble(obj);
    Py_DECREF(obj);
    if (*out == -1.0 && PyErr_Occurred()) return -1;
    return 0;
}

/* 1 keep / 0 drop / -1 error */
static int filter_eval(espec *sp, PyObject *value, PyObject *reproj_key) {
    if (sp->mode == 1) return 1;
    if (sp->mode == 2) {
        PyObject *v = PyDict_GetItemWithError(value, reproj_key);
        if (v == NULL) {
            if (PyErr_Occurred()) return -1;
            /* missing key: the closure would raise KeyError — replicate
             * through the exact fallback */
        } else if (PyFloat_Check(v)) {
            /* exact Python floats (incl. np.float64, a float subclass)
             * compare in double, identical to the closure's `<`.  Other
             * types (np.float32 under NEP 50 compares at f32 after casting
             * tau DOWN to f32 — not the same as this double compare near
             * the threshold) take the exact per-edge fallback. */
            return PyFloat_AS_DOUBLE(v) < sp->a ? 1 : 0;
        }
    }
    PyObject *keep = PyObject_CallOneArg(sp->call, value);
    if (keep == NULL) return -1;
    int truth = PyObject_IsTrue(keep);
    Py_DECREF(keep);
    return truth;
}

/* pack_edges2(src_edges, edge_filter, noise_r, noise_t, marker2idx, f64)
 * pack_edges3(..., filt_spec, nr_spec, nt_spec)
 *   -> (edata bytearray, eidx bytearray, raw bytearray, cam_list, time_list,
 *       E, skipped, ortho_ok)
 * cam_list/time_list hold the unique id strings in first-appearance order;
 * eidx stores indices into those provisional orders (the caller remaps to
 * lexicographic order — a vectorized numpy pass).  skipped counts edges
 * whose marker has no constraint.  ortho_ok is 1 iff every edge rotation is
 * orthonormal (max |R R^T - I| < 1e-3) and proper (det > 0.5): only then is
 * the quaternion transfer faithful to the raw matrices.  raw holds the
 * unconverted rotation entries (E x 9 doubles, row-major) so the caller can
 * take the raw-matrix path on gate failure WITHOUT re-running the user
 * callables (they may be stateful).
 */
static PyObject *pack_edges_impl(PyObject *args, int with_specs) {
    PyObject *src_edges, *edge_filter, *noise_r, *noise_t, *marker2idx;
    PyObject *filt_spec = NULL, *nr_spec = NULL, *nt_spec = NULL;
    int f64;
    if (with_specs) {
        if (!PyArg_ParseTuple(args, "OOOOOpOOO", &src_edges, &edge_filter,
                              &noise_r, &noise_t, &marker2idx, &f64,
                              &filt_spec, &nr_spec, &nt_spec))
            return NULL;
    } else if (!PyArg_ParseTuple(args, "OOOOOp", &src_edges, &edge_filter,
                                 &noise_r, &noise_t, &marker2idx, &f64))
        return NULL;
    if (!PyDict_Check(src_edges)) {
        PyErr_SetString(PyExc_TypeError, "src_edges must be a dict");
        return NULL;
    }
    espec filt_sp, nr_sp, nt_sp;
    if (parse_spec(filt_spec, edge_filter, &filt_sp, 1) < 0 ||
        parse_spec(nr_spec, noise_r, &nr_sp, 0) < 0 ||
        parse_spec(nt_spec, noise_t, &nt_sp, 0) < 0)
        return NULL;

    Py_ssize_t n = PyDict_Size(src_edges);
    size_t esz = f64 ? sizeof(double) : sizeof(float);
    /* C-side time-id intern table (allocated below, freed on every exit):
     * open-addressing FNV-1a hash over the time substring's UTF-8 bytes,
     * probed straight out of the tm key string — no per-edge substring
     * allocation, no PyLong boxing, no Python-dict insert (the headline
     * problem has ~95k unique "t_m" strings over 120k edges, so object-
     * level caching of whole tm strings mostly misses).  The byte pointers
     * stay valid for the whole call: they point into key strings owned by
     * src_edges.  The Python time substring is created exactly ONCE per
     * unique time, for time_list. */
    uint64_t *th_hash = NULL;
    const char **th_ptr = NULL;
    int32_t *th_meta = NULL; /* (time_idx, byte_len) pairs */
    PyObject *edata_ba = PyByteArray_FromStringAndSize(NULL, (n > 0 ? n : 1) * 9 * esz);
    PyObject *eidx_ba =
        PyByteArray_FromStringAndSize(NULL, (n > 0 ? n : 1) * 3 * sizeof(int32_t));
    PyObject *raw_ba =
        PyByteArray_FromStringAndSize(NULL, (n > 0 ? n : 1) * 9 * sizeof(double));
    PyObject *cam_map = PyDict_New();
    PyObject *cam_list = PyList_New(0), *time_list = PyList_New(0);
    PyObject *pose_key = PyUnicode_InternFromString("pose");
    PyObject *pose_attr = PyUnicode_InternFromString("_pose");
    PyObject *corners_key = PyUnicode_InternFromString("corners");
    PyObject *reproj_key = PyUnicode_InternFromString("reprojected_err");
    if (!edata_ba || !eidx_ba || !raw_ba || !cam_map ||
        !cam_list || !time_list || !pose_key || !pose_attr || !corners_key ||
        !reproj_key)
        goto fail;

    Py_ssize_t th_cap = 64;
    while (th_cap < 2 * (n + 1)) th_cap <<= 1;
    th_hash = malloc((size_t)th_cap * sizeof(uint64_t));
    th_ptr = malloc((size_t)th_cap * sizeof(char *));
    th_meta = malloc((size_t)th_cap * sizeof(int32_t) * 2);
    if (!th_hash || !th_ptr || !th_meta) {
        PyErr_NoMemory();
        goto fail;
    }
    memset(th_ptr, 0, (size_t)th_cap * sizeof(char *)); /* NULL = empty */

    /* C-side marker table (small constraint dicts): resolves the marker
     * substring by memcmp against the dict keys' UTF-8 — no m-string
     * allocation per miss.  Larger dicts fall back to the m-string lookup. */
#define FP_MAXMARK 64
    const char *mk_s[FP_MAXMARK];
    Py_ssize_t mk_len[FP_MAXMARK];
    long mk_idx[FP_MAXMARK];
    Py_ssize_t n_mark = -1;
    if (PyDict_Size(marker2idx) <= FP_MAXMARK) {
        n_mark = 0;
        PyObject *mk, *mv;
        Py_ssize_t mpos = 0;
        while (PyDict_Next(marker2idx, &mpos, &mk, &mv)) {
            Py_ssize_t l;
            const char *s = PyUnicode_Check(mk)
                                ? PyUnicode_AsUTF8AndSize(mk, &l)
                                : NULL;
            long iv = PyLong_AsLong(mv);
            if (s == NULL || (iv == -1 && PyErr_Occurred()) ||
                iv >= (1L << 21) || iv < 0) {
                PyErr_Clear();
                n_mark = -1;
                break;
            }
            mk_s[n_mark] = s;
            mk_len[n_mark] = l;
            mk_idx[n_mark] = iv;
            n_mark++;
        }
    }

    {
        char *edata = PyByteArray_AS_STRING(edata_ba);
        int32_t *eidx = (int32_t *)PyByteArray_AS_STRING(eidx_ba);
        double *raw = (double *)PyByteArray_AS_STRING(raw_ba);
        double max_dev = 0.0, min_det = 1.0;
        Py_ssize_t E = 0, skipped = 0;

        PyObject *key, *value;
        Py_ssize_t pos = 0;
        while (PyDict_Next(src_edges, &pos, &key, &value)) {
            /* The buffers were sized from the dict's initial length; the
             * user callables run below and could (incorrectly) grow the
             * dict mid-iteration — guard the capacity instead of writing
             * past the allocations. */
            if (E >= n) {
                PyErr_SetString(PyExc_RuntimeError,
                                "edge dict grew during packing (noise-model/"
                                "edge-filter callables must not mutate it)");
                goto fail;
            }
            int truth = filter_eval(&filt_sp, value, reproj_key);
            if (truth < 0) goto fail;
            if (!truth) continue;

            if (!PyTuple_Check(key) || PyTuple_GET_SIZE(key) != 2) {
                PyErr_Format(PyExc_TypeError, "edge key %R is not a 2-tuple", key);
                goto fail;
            }
            PyObject *cam = PyTuple_GET_ITEM(key, 0);
            PyObject *tm = PyTuple_GET_ITEM(key, 1);

            /* "t_m" split on the raw UTF-8 bytes ('_' = 0x5F never occurs
             * inside a multi-byte sequence) — no substring objects */
            Py_ssize_t tmlen;
            const char *tms = PyUnicode_AsUTF8AndSize(tm, &tmlen);
            if (tms == NULL) goto fail;
            const char *us = memchr(tms, '_', (size_t)tmlen);
            if (us == NULL) {
                PyErr_Format(PyExc_ValueError, "edge key %R has no '_'", tm);
                goto fail;
            }
            Py_ssize_t tlen = us - tms;
            const char *ms = us + 1;
            Py_ssize_t mlen = tmlen - tlen - 1;

            /* marker index: memcmp table (small dicts) / m-string lookup */
            long mi = -1;
            if (n_mark >= 0) {
                for (Py_ssize_t j = 0; j < n_mark; j++)
                    if (mk_len[j] == mlen && memcmp(mk_s[j], ms, mlen) == 0) {
                        mi = mk_idx[j];
                        break;
                    }
            } else {
                PyObject *m = PyUnicode_FromStringAndSize(ms, mlen);
                if (m == NULL) goto fail;
                PyObject *midx_obj = PyDict_GetItem(marker2idx, m);
                Py_DECREF(m);
                if (midx_obj != NULL) {
                    mi = PyLong_AsLong(midx_obj);
                    if (mi == -1 && PyErr_Occurred()) goto fail;
                }
            }
            if (mi < 0) {
                skipped++;
                continue;
            }

            /* noise models: recognized forms evaluate inline (see espec) */
            double kr, kt;
            if (noise_eval(&nr_sp, value, corners_key, &kr) < 0 ||
                noise_eval(&nt_sp, value, corners_key, &kt) < 0)
                goto fail;

            /* pose 4x4 -> rotation rows + translation (doubles) */
            PyObject *pose = PyDict_GetItemWithError(value, pose_key);
            if (pose == NULL) {
                if (!PyErr_Occurred())
                    PyErr_Format(PyExc_KeyError, "edge %R has no 'pose'", key);
                goto fail;
            }
            PyObject *parr = PyObject_GetAttr(pose, pose_attr);
            if (parr == NULL) goto fail;
            double m16[16];
            int got = read_f2d(parr, 4, 4, m16);
            Py_DECREF(parr);
            if (!got) {
                PyErr_SetString(PyExc_ValueError, "pose buffer is not 4x4 f32/f64");
                goto fail;
            }

            double r00 = m16[0], r01 = m16[1], r02 = m16[2], tx = m16[3];
            double r10 = m16[4], r11 = m16[5], r12 = m16[6], ty = m16[7];
            double r20 = m16[8], r21 = m16[9], r22 = m16[10], tz = m16[11];

            {
                double *rr = raw + E * 9;
                rr[0] = r00; rr[1] = r01; rr[2] = r02;
                rr[3] = r10; rr[4] = r11; rr[5] = r12;
                rr[6] = r20; rr[7] = r21; rr[8] = r22;
            }

            /* orthonormality / properness statistics (full-batch gate) */
            double d00 = r00 * r00 + r01 * r01 + r02 * r02 - 1.0;
            double d11 = r10 * r10 + r11 * r11 + r12 * r12 - 1.0;
            double d22 = r20 * r20 + r21 * r21 + r22 * r22 - 1.0;
            double d01 = r00 * r10 + r01 * r11 + r02 * r12;
            double d02 = r00 * r20 + r01 * r21 + r02 * r22;
            double d12 = r10 * r20 + r11 * r21 + r12 * r22;
            double dev = fabs(d00);
            if (fabs(d11) > dev) dev = fabs(d11);
            if (fabs(d22) > dev) dev = fabs(d22);
            if (fabs(d01) > dev) dev = fabs(d01);
            if (fabs(d02) > dev) dev = fabs(d02);
            if (fabs(d12) > dev) dev = fabs(d12);
            if (dev > max_dev) max_dev = dev;
            double det = r00 * (r11 * r22 - r12 * r21) -
                         r01 * (r10 * r22 - r12 * r20) +
                         r02 * (r10 * r21 - r11 * r20);
            if (det < min_det) min_det = det;

            /* Shepperd rotation -> quaternion (same branch selection as the
             * pure-Python _mat_to_quat) */
            double q0, q1, q2, q3, s;
            double tr = r00 + r11 + r22;
            if (tr > 0.0) {
                s = sqrt(fmax(tr + 1.0, 1e-12)) * 2.0;
                q0 = 0.25 * s;
                q1 = (r21 - r12) / s;
                q2 = (r02 - r20) / s;
                q3 = (r10 - r01) / s;
            } else if (r00 >= r11 && r00 >= r22) {
                s = sqrt(fmax(1.0 + r00 - r11 - r22, 1e-12)) * 2.0;
                q0 = (r21 - r12) / s;
                q1 = 0.25 * s;
                q2 = (r01 + r10) / s;
                q3 = (r02 + r20) / s;
            } else if (r11 >= r22) {
                s = sqrt(fmax(1.0 + r11 - r00 - r22, 1e-12)) * 2.0;
                q0 = (r02 - r20) / s;
                q1 = (r01 + r10) / s;
                q2 = 0.25 * s;
                q3 = (r12 + r21) / s;
            } else {
                s = sqrt(fmax(1.0 + r22 - r00 - r11, 1e-12)) * 2.0;
                q0 = (r10 - r01) / s;
                q1 = (r02 + r20) / s;
                q2 = (r12 + r21) / s;
                q3 = 0.25 * s;
            }
            double qn = sqrt(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
            if (qn < 1e-30) qn = 1e-30;
            q0 /= qn; q1 /= qn; q2 /= qn; q3 /= qn;

            if (f64) {
                double *row = (double *)edata + E * 9;
                row[0] = q0; row[1] = q1; row[2] = q2; row[3] = q3;
                row[4] = tx; row[5] = ty; row[6] = tz;
                row[7] = kr; row[8] = kt;
            } else {
                float *row = (float *)edata + E * 9;
                row[0] = (float)q0; row[1] = (float)q1;
                row[2] = (float)q2; row[3] = (float)q3;
                row[4] = (float)tx; row[5] = (float)ty; row[6] = (float)tz;
                row[7] = (float)kr; row[8] = (float)kt;
            }

            long ci = intern_id(cam_map, cam_list, cam);
            if (ci < 0) goto fail;

            /* time index via the C hash table (first-appearance order) */
            uint64_t h = 1469598103934665603ULL; /* FNV-1a offset basis */
            for (Py_ssize_t j = 0; j < tlen; j++)
                h = (h ^ (unsigned char)tms[j]) * 1099511628211ULL;
            Py_ssize_t slot = (Py_ssize_t)(h & (uint64_t)(th_cap - 1));
            long ti = -1;
            while (th_ptr[slot] != NULL) {
                if (th_hash[slot] == h && th_meta[2 * slot + 1] == tlen &&
                    memcmp(th_ptr[slot], tms, (size_t)tlen) == 0) {
                    ti = th_meta[2 * slot];
                    break;
                }
                slot = (slot + 1) & (th_cap - 1);
            }
            if (ti < 0) {
                PyObject *t = PyUnicode_FromStringAndSize(tms, tlen);
                if (t == NULL) goto fail;
                ti = (long)PyList_GET_SIZE(time_list);
                int bad = PyList_Append(time_list, t);
                Py_DECREF(t);
                if (bad) goto fail;
                th_hash[slot] = h;
                th_ptr[slot] = tms;
                th_meta[2 * slot] = (int32_t)ti;
                th_meta[2 * slot + 1] = (int32_t)tlen;
            }

            eidx[E * 3 + 0] = (int32_t)ci;
            eidx[E * 3 + 1] = (int32_t)ti;
            eidx[E * 3 + 2] = (int32_t)mi;
            E++;
        }

        if (PyByteArray_Resize(edata_ba, E * 9 * esz) < 0) goto fail;
        if (PyByteArray_Resize(eidx_ba, E * 3 * sizeof(int32_t)) < 0) goto fail;
        if (PyByteArray_Resize(raw_ba, E * 9 * sizeof(double)) < 0) goto fail;
        free(th_hash);
        free(th_ptr);
        free(th_meta);
        Py_DECREF(cam_map);
        Py_DECREF(pose_key);
        Py_DECREF(pose_attr);
        Py_DECREF(corners_key);
        Py_DECREF(reproj_key);
        int ortho_ok = (E == 0) || (max_dev < 1e-3 && min_det > 0.5);
        return Py_BuildValue("(NNNNNnni)", edata_ba, eidx_ba, raw_ba, cam_list,
                             time_list, E, skipped, ortho_ok);
    }

fail:
    free(th_hash);
    free(th_ptr);
    free(th_meta);
    Py_XDECREF(edata_ba);
    Py_XDECREF(eidx_ba);
    Py_XDECREF(raw_ba);
    Py_XDECREF(cam_map);
    Py_XDECREF(cam_list);
    Py_XDECREF(time_list);
    Py_XDECREF(pose_key);
    Py_XDECREF(pose_attr);
    Py_XDECREF(corners_key);
    Py_XDECREF(reproj_key);
    return NULL;
}

static PyObject *pack_edges2(PyObject *self, PyObject *args) {
    (void)self;
    return pack_edges_impl(args, 0);
}

static PyObject *pack_edges3(PyObject *self, PyObject *args) {
    (void)self;
    return pack_edges_impl(args, 1);
}

static PyMethodDef methods[] = {
    {"pack_edges2", pack_edges2, METH_VARARGS,
     "One-pass edge-dict -> fused (E,9)+(E,3) device buffers."},
    {"pack_edges3", pack_edges3, METH_VARARGS,
     "pack_edges2 + recognized noise/filter spec tuples evaluated inline."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastpack", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit_fastpack(void) {
    import_array();  /* numpy C-API (sets an exception and returns on failure) */
    return PyModule_Create(&moduledef);
}
