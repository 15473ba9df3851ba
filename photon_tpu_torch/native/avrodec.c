/* Native Avro binary block decoder.
 *
 * The runtime half of the from-scratch Avro codec (photon_tpu_torch/io/avro.py):
 * the pure-Python record decoder tops out around 50k records/s on
 * bag-of-features data (every record is ~100 varint/string decode calls),
 * which makes ingest decode-bound. This CPython extension walks a
 * pre-compiled schema "program" (nested tuples of integer opcodes built by
 * photon_tpu_torch/io/avro.py:schema_to_program) over one decompressed container
 * block and materializes the same Python objects the interpreter codec
 * produces — dicts for records, lists for arrays, etc. — at millions of
 * records per second.
 *
 * Counterpart of the reference's data-loader layer (AvroUtils.scala:62 /
 * AvroDataReader.scala:54, which lean on the JVM Avro runtime's generated
 * decoders); built lazily by photon_tpu_torch/native/__init__.py with the system
 * compiler and loaded as an extension module, with transparent fallback to
 * the interpreter codec when unavailable.
 *
 * Program encoding (must match schema_to_program):
 *   (0,)                      null
 *   (1,)                      boolean
 *   (2,)                      int/long         -> PyLong
 *   (3,)                      float            -> PyFloat
 *   (4,)                      double           -> PyFloat
 *   (5,)                      string           -> str
 *   (6,)                      bytes            -> bytes
 *   (7, names, progs)         record           -> dict  (names: tuple[str])
 *   (8, item_prog)            array            -> list
 *   (9, value_prog)           map              -> dict
 *   (10, branch_progs)        union            (long index, then branch)
 *   (11, symbols)             enum             -> str
 *   (12, size)                fixed            -> bytes
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

typedef struct {
    const unsigned char *data;
    Py_ssize_t pos;
    Py_ssize_t len;
} Cursor;

static int
cursor_fail(const char *what)
{
    PyErr_Format(PyExc_EOFError, "truncated input: %s", what);
    return -1;
}

/* zigzag varint -> int64; returns -1 on error (with exception set). */
static int
read_long(Cursor *c, long long *out)
{
    unsigned long long acc = 0;
    int shift = 0;
    for (;;) {
        unsigned char b;
        if (c->pos >= c->len)
            return cursor_fail("varint");
        b = c->data[c->pos++];
        acc |= ((unsigned long long)(b & 0x7F)) << shift;
        if (!(b & 0x80))
            break;
        shift += 7;
        if (shift > 63) {
            PyErr_SetString(PyExc_ValueError, "varint too long");
            return -1;
        }
    }
    *out = (long long)(acc >> 1) ^ -(long long)(acc & 1);
    return 0;
}

static int
read_exact(Cursor *c, Py_ssize_t n, const unsigned char **out)
{
    if (n < 0 || c->pos + n > c->len)
        return cursor_fail("bytes");
    *out = c->data + c->pos;
    c->pos += n;
    return 0;
}

/* Forward declaration. */
static PyObject *decode_node(Cursor *c, PyObject *prog);

static PyObject *
decode_node(Cursor *c, PyObject *prog)
{
    long op;
    long long n;
    const unsigned char *raw;

    if (!PyTuple_Check(prog) || PyTuple_GET_SIZE(prog) < 1) {
        PyErr_SetString(PyExc_TypeError, "bad program node");
        return NULL;
    }
    op = PyLong_AsLong(PyTuple_GET_ITEM(prog, 0));
    if (op == -1 && PyErr_Occurred())
        return NULL;

    switch (op) {
    case 0: /* null */
        Py_RETURN_NONE;
    case 1: /* boolean */
        if (read_exact(c, 1, &raw) < 0)
            return NULL;
        if (raw[0])
            Py_RETURN_TRUE;
        Py_RETURN_FALSE;
    case 2: /* int/long */
        if (read_long(c, &n) < 0)
            return NULL;
        return PyLong_FromLongLong(n);
    case 3: { /* float */
        float f;
        if (read_exact(c, 4, &raw) < 0)
            return NULL;
        memcpy(&f, raw, 4);
        return PyFloat_FromDouble((double)f);
    }
    case 4: { /* double */
        double d;
        if (read_exact(c, 8, &raw) < 0)
            return NULL;
        memcpy(&d, raw, 8);
        return PyFloat_FromDouble(d);
    }
    case 5: /* string */
        if (read_long(c, &n) < 0)
            return NULL;
        if (read_exact(c, (Py_ssize_t)n, &raw) < 0)
            return NULL;
        return PyUnicode_DecodeUTF8((const char *)raw, (Py_ssize_t)n, NULL);
    case 6: /* bytes */
        if (read_long(c, &n) < 0)
            return NULL;
        if (read_exact(c, (Py_ssize_t)n, &raw) < 0)
            return NULL;
        return PyBytes_FromStringAndSize((const char *)raw, (Py_ssize_t)n);
    case 7: { /* record */
        PyObject *names = PyTuple_GET_ITEM(prog, 1);
        PyObject *progs = PyTuple_GET_ITEM(prog, 2);
        Py_ssize_t nf = PyTuple_GET_SIZE(names);
        PyObject *d = PyDict_New();
        Py_ssize_t i;
        if (d == NULL)
            return NULL;
        for (i = 0; i < nf; i++) {
            PyObject *v = decode_node(c, PyTuple_GET_ITEM(progs, i));
            if (v == NULL) {
                Py_DECREF(d);
                return NULL;
            }
            if (PyDict_SetItem(d, PyTuple_GET_ITEM(names, i), v) < 0) {
                Py_DECREF(v);
                Py_DECREF(d);
                return NULL;
            }
            Py_DECREF(v);
        }
        return d;
    }
    case 8: { /* array: blocks until 0 count; negative => byte size follows */
        PyObject *item_prog = PyTuple_GET_ITEM(prog, 1);
        PyObject *list = PyList_New(0);
        if (list == NULL)
            return NULL;
        for (;;) {
            long long count, i;
            if (read_long(c, &count) < 0)
                goto arr_fail;
            if (count == 0)
                break;
            if (count < 0) {
                long long sz;
                count = -count;
                if (read_long(c, &sz) < 0)
                    goto arr_fail;
            }
            for (i = 0; i < count; i++) {
                PyObject *v = decode_node(c, item_prog);
                if (v == NULL)
                    goto arr_fail;
                if (PyList_Append(list, v) < 0) {
                    Py_DECREF(v);
                    goto arr_fail;
                }
                Py_DECREF(v);
            }
        }
        return list;
    arr_fail:
        Py_DECREF(list);
        return NULL;
    }
    case 9: { /* map */
        PyObject *val_prog = PyTuple_GET_ITEM(prog, 1);
        PyObject *d = PyDict_New();
        if (d == NULL)
            return NULL;
        for (;;) {
            long long count, i;
            if (read_long(c, &count) < 0)
                goto map_fail;
            if (count == 0)
                break;
            if (count < 0) {
                long long sz;
                count = -count;
                if (read_long(c, &sz) < 0)
                    goto map_fail;
            }
            for (i = 0; i < count; i++) {
                PyObject *k, *v;
                long long klen;
                if (read_long(c, &klen) < 0)
                    goto map_fail;
                if (read_exact(c, (Py_ssize_t)klen, &raw) < 0)
                    goto map_fail;
                k = PyUnicode_DecodeUTF8(
                    (const char *)raw, (Py_ssize_t)klen, NULL);
                if (k == NULL)
                    goto map_fail;
                v = decode_node(c, val_prog);
                if (v == NULL) {
                    Py_DECREF(k);
                    goto map_fail;
                }
                if (PyDict_SetItem(d, k, v) < 0) {
                    Py_DECREF(k);
                    Py_DECREF(v);
                    goto map_fail;
                }
                Py_DECREF(k);
                Py_DECREF(v);
            }
        }
        return d;
    map_fail:
        Py_DECREF(d);
        return NULL;
    }
    case 10: { /* union */
        PyObject *branches = PyTuple_GET_ITEM(prog, 1);
        if (read_long(c, &n) < 0)
            return NULL;
        if (n < 0 || n >= PyTuple_GET_SIZE(branches)) {
            PyErr_Format(PyExc_ValueError,
                         "union index %lld out of range", n);
            return NULL;
        }
        return decode_node(c, PyTuple_GET_ITEM(branches, (Py_ssize_t)n));
    }
    case 11: { /* enum */
        PyObject *symbols = PyTuple_GET_ITEM(prog, 1);
        PyObject *sym;
        if (read_long(c, &n) < 0)
            return NULL;
        if (n < 0 || n >= PyTuple_GET_SIZE(symbols)) {
            PyErr_Format(PyExc_ValueError,
                         "enum index %lld out of range", n);
            return NULL;
        }
        sym = PyTuple_GET_ITEM(symbols, (Py_ssize_t)n);
        Py_INCREF(sym);
        return sym;
    }
    case 12: { /* fixed */
        long long size = PyLong_AsLongLong(PyTuple_GET_ITEM(prog, 1));
        if (size == -1 && PyErr_Occurred())
            return NULL;
        if (read_exact(c, (Py_ssize_t)size, &raw) < 0)
            return NULL;
        return PyBytes_FromStringAndSize((const char *)raw,
                                         (Py_ssize_t)size);
    }
    default:
        PyErr_Format(PyExc_ValueError, "bad opcode %ld", op);
        return NULL;
    }
}

/* decode_block(data: bytes, count: int, program: tuple) -> list */
static PyObject *
avrodec_decode_block(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    Py_ssize_t count, i;
    PyObject *prog, *out;
    Cursor c;

    if (!PyArg_ParseTuple(args, "y*nO", &buf, &count, &prog))
        return NULL;
    c.data = (const unsigned char *)buf.buf;
    c.pos = 0;
    c.len = buf.len;

    out = PyList_New(count);
    if (out == NULL) {
        PyBuffer_Release(&buf);
        return NULL;
    }
    for (i = 0; i < count; i++) {
        PyObject *rec = decode_node(&c, prog);
        if (rec == NULL) {
            Py_DECREF(out);
            PyBuffer_Release(&buf);
            return NULL;
        }
        PyList_SET_ITEM(out, i, rec); /* steals */
    }
    if (c.pos != c.len) {
        PyErr_Format(PyExc_ValueError,
                     "block decode consumed %zd of %zd bytes",
                     c.pos, c.len);
        Py_DECREF(out);
        PyBuffer_Release(&buf);
        return NULL;
    }
    PyBuffer_Release(&buf);
    return out;
}

static PyMethodDef avrodec_methods[] = {
    {"decode_block", avrodec_decode_block, METH_VARARGS,
     "Decode one decompressed Avro container block into a list of records."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef avrodec_module = {
    PyModuleDef_HEAD_INIT, "photon_avrodec",
    "Native Avro binary block decoder.", -1, avrodec_methods,
};

PyMODINIT_FUNC
PyInit_photon_avrodec(void)
{
    return PyModule_Create(&avrodec_module);
}
