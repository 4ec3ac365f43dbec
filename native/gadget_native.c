/* gadget_native — native runtime helpers for gadget_leicester_tpu.
 *
 * Rebuild of the reference's host-side hot paths:
 *   - Peano-Hilbert keys [G2: peano.c :: peano_hilbert_key()] via the
 *     Skilling transpose algorithm (fresh implementation, not the
 *     reference's rotation lookup tables — same curve, same locality
 *     property used for domain decomposition).
 *   - F77 unformatted record scanning for GADGET fmt 1/2 snapshots
 *     [G2: read_ic.c record framing] with endian detection.
 *   - Parallel CIC deposit for host-side IC/analysis tooling.
 *
 * Plain CPython C API (no pybind11 in the image); buffers in/out via the
 * buffer protocol; numpy wraps results with np.frombuffer zero-copy.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

/* ---------------- Peano-Hilbert keys (Skilling transpose) -------------- */

/* Convert one (x,y,z) coordinate triple (each < 2^bits) to its Hilbert
 * curve index of 3*bits bits. Skilling's algorithm: transpose form. */
static uint64_t hilbert_key_3d(uint32_t x, uint32_t y, uint32_t z, int bits)
{
    uint32_t X[3] = {x, y, z};
    uint32_t M = 1u << (bits - 1), P, Q, t;
    int i;

    /* Inverse undo excess work (Skilling: AxestoTranspose) */
    for (Q = M; Q > 1; Q >>= 1) {
        P = Q - 1;
        for (i = 0; i < 3; i++) {
            if (X[i] & Q)
                X[0] ^= P; /* invert */
            else {
                t = (X[0] ^ X[i]) & P;
                X[0] ^= t;
                X[i] ^= t;
            }
        }
    }
    /* Gray encode */
    for (i = 1; i < 3; i++)
        X[i] ^= X[i - 1];
    t = 0;
    for (Q = M; Q > 1; Q >>= 1)
        if (X[2] & Q)
            t ^= Q - 1;
    for (i = 0; i < 3; i++)
        X[i] ^= t;

    /* interleave the transpose bits: key bit (3*b + dim) */
    uint64_t key = 0;
    for (i = bits - 1; i >= 0; i--) {
        key = (key << 1) | ((X[0] >> i) & 1u);
        key = (key << 1) | ((X[1] >> i) & 1u);
        key = (key << 1) | ((X[2] >> i) & 1u);
    }
    return key;
}

static PyObject *py_peano_hilbert_keys(PyObject *self, PyObject *args)
{
    Py_buffer coords;
    int bits;
    if (!PyArg_ParseTuple(args, "y*i", &coords, &bits))
        return NULL;
    if (bits < 1 || bits > 21) {
        PyBuffer_Release(&coords);
        PyErr_SetString(PyExc_ValueError, "bits must be in [1, 21]");
        return NULL;
    }
    if (coords.len % (3 * (Py_ssize_t)sizeof(uint32_t)) != 0) {
        PyBuffer_Release(&coords);
        PyErr_SetString(PyExc_ValueError,
                        "coords must be n*3 uint32 (C-contiguous)");
        return NULL;
    }
    Py_ssize_t n = coords.len / (3 * sizeof(uint32_t));
    PyObject *out = PyBytes_FromStringAndSize(NULL, n * sizeof(uint64_t));
    if (!out) {
        PyBuffer_Release(&coords);
        return NULL;
    }
    const uint32_t *c = (const uint32_t *)coords.buf;
    uint64_t *k = (uint64_t *)PyBytes_AS_STRING(out);
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++)
        k[i] = hilbert_key_3d(c[3 * i], c[3 * i + 1], c[3 * i + 2], bits);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&coords);
    return out;
}

/* ---------------- F77 record scan ------------------------------------- */

static uint32_t bswap32(uint32_t v)
{
    return ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) | ((v >> 8) & 0xFF00) |
           (v >> 24);
}

/* scan_f77_records(data) -> (little_endian: bool, [(payload_off, size)...])
 * Walks marker/payload/marker framing; raises ValueError on corruption. */
static PyObject *py_scan_f77_records(PyObject *self, PyObject *args)
{
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "y*", &data))
        return NULL;
    const unsigned char *p = (const unsigned char *)data.buf;
    Py_ssize_t len = data.len;
    if (len < 8) {
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_ValueError, "file too short");
        return NULL;
    }
    uint32_t first;
    memcpy(&first, p, 4);
    int swap = 0;
    /* GADGET first record is 256 (fmt1 header) or 8 (fmt2 label) */
    if (first != 256 && first != 8) {
        if (bswap32(first) == 256 || bswap32(first) == 8)
            swap = 1;
        else {
            PyBuffer_Release(&data);
            PyErr_Format(PyExc_ValueError,
                         "not a GADGET fmt1/2 file (first marker 0x%x)",
                         first);
            return NULL;
        }
    }
    PyObject *list = PyList_New(0);
    if (!list) {
        PyBuffer_Release(&data);
        return NULL;
    }
    Py_ssize_t off = 0;
    while (off + 8 <= len) {
        uint32_t m0, m1;
        memcpy(&m0, p + off, 4);
        if (swap)
            m0 = bswap32(m0);
        if (off + 8 + (Py_ssize_t)m0 > len) {
            Py_DECREF(list);
            PyBuffer_Release(&data);
            PyErr_Format(PyExc_ValueError,
                         "truncated record at offset %zd (size %u)", off, m0);
            return NULL;
        }
        memcpy(&m1, p + off + 4 + m0, 4);
        if (swap)
            m1 = bswap32(m1);
        if (m1 != m0) {
            Py_DECREF(list);
            PyBuffer_Release(&data);
            PyErr_Format(PyExc_ValueError,
                         "record marker mismatch at offset %zd: %u vs %u",
                         off, m0, m1);
            return NULL;
        }
        PyObject *tup = Py_BuildValue("(nI)", off + 4, m0);
        if (!tup || PyList_Append(list, tup) < 0) {
            Py_XDECREF(tup);
            Py_DECREF(list);
            PyBuffer_Release(&data);
            return NULL;
        }
        Py_DECREF(tup);
        off += 8 + m0;
    }
    PyBuffer_Release(&data);
    return Py_BuildValue("(iN)", swap ? 0 : 1, list);
}

/* ---------------- CIC deposit (host tooling) --------------------------- */

static PyObject *py_cic_deposit_f32(PyObject *self, PyObject *args)
{
    Py_buffer pos, mass;
    int g;
    double box;
    if (!PyArg_ParseTuple(args, "y*y*id", &pos, &mass, &g, &box))
        return NULL;
    Py_ssize_t n = mass.len / (Py_ssize_t)sizeof(float);
    if (pos.len != n * 3 * (Py_ssize_t)sizeof(float) || g < 1) {
        PyBuffer_Release(&pos);
        PyBuffer_Release(&mass);
        PyErr_SetString(PyExc_ValueError, "shape mismatch");
        return NULL;
    }
    Py_ssize_t gs = (Py_ssize_t)g * g * g;
    PyObject *out = PyBytes_FromStringAndSize(NULL, gs * sizeof(float));
    if (!out) {
        PyBuffer_Release(&pos);
        PyBuffer_Release(&mass);
        return NULL;
    }
    float *grid = (float *)PyBytes_AS_STRING(out);
    memset(grid, 0, gs * sizeof(float));
    const float *xp = (const float *)pos.buf;
    const float *mp = (const float *)mass.buf;
    const double inv = g / box;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++) {
        double u0 = xp[3 * i] * inv, u1 = xp[3 * i + 1] * inv,
               u2 = xp[3 * i + 2] * inv;
        long i0 = (long)u0, i1 = (long)u1, i2 = (long)u2;
        double f0 = u0 - i0, f1 = u1 - i1, f2 = u2 - i2;
        long j0 = (i0 + 1) % g, j1 = (i1 + 1) % g, j2 = (i2 + 1) % g;
        i0 %= g; i1 %= g; i2 %= g;
        float m = mp[i];
        grid[(i0 * g + i1) * g + i2] += m * (1 - f0) * (1 - f1) * (1 - f2);
        grid[(i0 * g + i1) * g + j2] += m * (1 - f0) * (1 - f1) * f2;
        grid[(i0 * g + j1) * g + i2] += m * (1 - f0) * f1 * (1 - f2);
        grid[(i0 * g + j1) * g + j2] += m * (1 - f0) * f1 * f2;
        grid[(j0 * g + i1) * g + i2] += m * f0 * (1 - f1) * (1 - f2);
        grid[(j0 * g + i1) * g + j2] += m * f0 * (1 - f1) * f2;
        grid[(j0 * g + j1) * g + i2] += m * f0 * f1 * (1 - f2);
        grid[(j0 * g + j1) * g + j2] += m * f0 * f1 * f2;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&pos);
    PyBuffer_Release(&mass);
    return out;
}

/* ---------------- module ------------------------------------------------ */

static PyMethodDef methods[] = {
    {"peano_hilbert_keys", py_peano_hilbert_keys, METH_VARARGS,
     "peano_hilbert_keys(coords_u32_bytes, bits) -> uint64-key bytes"},
    {"scan_f77_records", py_scan_f77_records, METH_VARARGS,
     "scan_f77_records(data) -> (is_little_endian, [(payload_off, size)])"},
    {"cic_deposit_f32", py_cic_deposit_f32, METH_VARARGS,
     "cic_deposit_f32(pos_f32, mass_f32, grid_n, box) -> grid bytes"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "gadget_native",
    "Native helpers: Peano-Hilbert keys, F77 record scan, CIC deposit.",
    -1, methods};

PyMODINIT_FUNC PyInit_gadget_native(void)
{
    return PyModule_Create(&moduledef);
}
