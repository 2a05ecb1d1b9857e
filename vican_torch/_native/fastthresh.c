/* fastthresh — adaptive mean-C threshold sweep, bit-packed output.
 *
 * The perception host and roi modes threshold on the HOST, and
 * cv2.boxFilter across 7 window sizes measured ~20 ms/image at 720p on one
 * core.  This kernel builds ONE replicate-padded integral image and sweeps
 * every window size off it, emitting the bit-packed (Wn, H, ceil(W/8))
 * masks the packed CCL kernel (fastccl.c) consumes directly: ~4x faster
 * and no (B, Wn, H, W) mask materialization.  This file is a copy of
 * vican_tpu/_native/fastthresh.c, which the JAX package builds the same way,
 * except that this copy releases the GIL around its loops, so perception's
 * feed thread thresholds while the calling thread runs detection.
 *
 * Exactness: box sums are exact integers, and the foreground test
 * ``(g + C) * win^2 <= sum`` (for integral C) is equivalent to the device
 * threshold's float32 ``g <= sum/win^2 - C`` (ops/threshold.adaptive_threshold):
 * for integer sums the f32 quotient is more than 1/win^2 away from the
 * decision boundary except at exact ties, where s/win^2 is exactly
 * representable — so the two tests agree on EVERY pixel.  Replicate
 * borders (cv.BORDER_REPLICATE) are folded into the padded integral.
 *
 * Reference behavior: cv.adaptiveThreshold(ADAPTIVE_THRESH_MEAN_C,
 * THRESH_BINARY_INV) inside detectMarkers (reference vican/cam.py:147,
 * window params cam.py:132-135).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* threshold_pack(gray_bytes, H, W, wins_tuple, C)
 *   gray: contiguous uint8 (H, W)
 *   wins: tuple of odd ints (ascending not required), max win <= 2*R_MAX+1
 *   C: threshold constant (float; integer fast path when integral)
 * Returns bytes of (Wn, H, Wb) with Wb = ceil(W/8), bit x of a row at
 * row[x >> 3] >> (x & 7) (np.packbits bitorder="little").
 */
static PyObject *threshold_pack(PyObject *self, PyObject *args) {
    Py_buffer gray;
    Py_ssize_t H, W;
    PyObject *wins_obj;
    double C;
    if (!PyArg_ParseTuple(args, "y*nnOd", &gray, &H, &W, &wins_obj, &C))
        return NULL;
    if (gray.len < H * W) {
        PyBuffer_Release(&gray);
        PyErr_SetString(PyExc_ValueError, "gray buffer too small");
        return NULL;
    }
    Py_ssize_t Wn = PyTuple_Size(wins_obj);
    if (Wn < 0) { PyBuffer_Release(&gray); return NULL; }
    long wins[64];
    long rmax = 0;
    if (Wn > 64) {
        PyBuffer_Release(&gray);
        PyErr_SetString(PyExc_ValueError, "too many windows");
        return NULL;
    }
    for (Py_ssize_t i = 0; i < Wn; i++) {
        wins[i] = PyLong_AsLong(PyTuple_GetItem(wins_obj, i));
        if (wins[i] <= 0 || !(wins[i] & 1)) {
            PyBuffer_Release(&gray);
            PyErr_SetString(PyExc_ValueError, "window sizes must be odd positive");
            return NULL;
        }
        if (wins[i] / 2 > rmax) rmax = wins[i] / 2;
    }
    const uint8_t *g = (const uint8_t *)gray.buf;
    const long R = rmax;
    const Py_ssize_t PW = W + 2 * R;   /* padded dims */
    const Py_ssize_t PH = H + 2 * R;
    const Py_ssize_t IS = PW + 1;      /* integral row stride */
    const Py_ssize_t Wb = (W + 7) / 8;

    int32_t *ii = (int32_t *)malloc((size_t)(PH + 1) * IS * sizeof(int32_t));
    uint8_t *cmp = (uint8_t *)malloc((size_t)W);
    uint8_t *out = (uint8_t *)calloc((size_t)Wn * H * Wb, 1);
    if (!ii || !cmp || !out) {
        free(ii); free(cmp); free(out);
        PyBuffer_Release(&gray);
        return PyErr_NoMemory();
    }

    /* the integral image and the sweep touch no Python object: other
     * threads run while they do */
    Py_BEGIN_ALLOW_THREADS
    /* replicate-padded integral image: padded pixel (py, px) reads
     * g[clamp(py-R), clamp(px-R)] */
    memset(ii, 0, (size_t)IS * sizeof(int32_t));
    for (Py_ssize_t py = 0; py < PH; py++) {
        Py_ssize_t y = py - R;
        if (y < 0) y = 0;
        if (y >= H) y = H - 1;
        const uint8_t *row = g + y * W;
        int32_t *cur = ii + (py + 1) * IS;
        const int32_t *up = ii + py * IS;
        cur[0] = 0;
        int32_t acc = 0;
        /* left replicate run */
        for (Py_ssize_t px = 0; px < R; px++) {
            acc += row[0];
            cur[px + 1] = up[px + 1] + acc;
        }
        for (Py_ssize_t px = R; px < R + W; px++) {
            acc += row[px - R];
            cur[px + 1] = up[px + 1] + acc;
        }
        for (Py_ssize_t px = R + W; px < PW; px++) {
            acc += row[W - 1];
            cur[px + 1] = up[px + 1] + acc;
        }
    }

    const int c_integral = (C == floor(C));
    const int32_t Ci = (int32_t)C;
    for (Py_ssize_t wi = 0; wi < Wn; wi++) {
        const long win = wins[wi];
        const long r = win / 2;
        const int32_t area = (int32_t)(win * win);
        uint8_t *dst = out + (size_t)wi * H * Wb;
        for (Py_ssize_t y = 0; y < H; y++) {
            /* window rows in padded coords: [y+R-r, y+R+r] inclusive */
            const int32_t *top = ii + (y + R - r) * IS;
            const int32_t *bot = ii + (y + R + r + 1) * IS;
            const uint8_t *row = g + y * W;
            /* window cols in padded coords: [x+R-r, x+R+r] inclusive */
            const int32_t *tl = top + (R - r);
            const int32_t *tr = top + (R + r + 1);
            const int32_t *bl = bot + (R - r);
            const int32_t *br = bot + (R + r + 1);
            if (c_integral) {
                const int32_t bias = Ci * area;
                for (Py_ssize_t x = 0; x < W; x++) {
                    int32_t s = br[x] - bl[x] - tr[x] + tl[x];
                    cmp[x] = (int32_t)row[x] * area + bias <= s;
                }
            } else {
                for (Py_ssize_t x = 0; x < W; x++) {
                    int32_t s = br[x] - bl[x] - tr[x] + tl[x];
                    cmp[x] = (double)row[x] <= (double)s / area - C;
                }
            }
            uint8_t *drow = dst + y * Wb;
            Py_ssize_t x = 0;
            for (; x + 8 <= W; x += 8) {
                drow[x >> 3] = (uint8_t)(cmp[x] | (cmp[x + 1] << 1) |
                                         (cmp[x + 2] << 2) | (cmp[x + 3] << 3) |
                                         (cmp[x + 4] << 4) | (cmp[x + 5] << 5) |
                                         (cmp[x + 6] << 6) | (cmp[x + 7] << 7));
            }
            if (x < W) {
                uint8_t b = 0;
                for (Py_ssize_t k = 0; x + k < W; k++) b |= cmp[x + k] << k;
                drow[x >> 3] = b;
            }
        }
    }
    Py_END_ALLOW_THREADS

    free(ii);
    free(cmp);
    PyBuffer_Release(&gray);
    PyObject *res = PyBytes_FromStringAndSize((char *)out, (Py_ssize_t)Wn * H * Wb);
    free(out);
    return res;
}

static PyMethodDef methods[] = {
    {"threshold_pack", threshold_pack, METH_VARARGS,
     "Adaptive mean-C threshold sweep over one integral image; packed bits."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastthresh", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit_fastthresh(void) { return PyModule_Create(&moduledef); }
