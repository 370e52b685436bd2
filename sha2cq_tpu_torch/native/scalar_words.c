/* Canonical BN254 Fr words of a list of Python ints, in one pass.

   fr_words(seq, start, stop, out) walks a list or tuple from index
   `start` and writes each element's four little-endian 64-bit words to
   out[4 i ..] while the element is an exact int (PyLong_CheckExact: no
   bool, no subclass) in [0, r).  It returns the index of the first
   element it did not take, or the end when it took every one; the caller
   reduces that element in Python and calls again from the next index.
   The end is the smaller of `stop` (the rows of out) and len(seq), so a
   list that a scalar's __mod__ lengthened is never read past out.

   It reads Python objects, so it runs with the GIL held: load it with
   ctypes.PyDLL and pass the sequence as a py_object.  Built against the
   running interpreter's headers (sha2cq_tpu_torch/scalar_words.py). */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

static const uint64_t FR_R[4] = {
    0x43E1F593F0000001ULL, 0x2833E84879B97091ULL,
    0xB85045B68181585DULL, 0x30644E72E131A029ULL};

/* 1 when the words w (little-endian) hold a value below r */
static inline int below_r(const uint64_t *w) {
    for (int j = 3; j >= 0; j--)
        if (w[j] != FR_R[j])
            return w[j] < FR_R[j];
    return 0;
}

/* The words of the exact int v in w; 0 when v is negative or needs more
   than 256 bits (w then holds nothing of use). */
static inline int int_words(PyObject *v, uint64_t *w) {
#if PY_VERSION_HEX >= 0x030C0000 && PY_VERSION_HEX < 0x030D0000 && \
    PYLONG_BITS_IN_DIGIT == 30 && !defined(SCALAR_WORDS_PUBLIC_API)
    /* CPython 3.12's layout: lv_tag holds the sign in its low two bits
       (2: negative) and the digit count above bit 3; 30-bit digits. */
    const PyLongObject *l = (const PyLongObject *)v;
    uintptr_t tag = l->long_value.lv_tag;
    Py_ssize_t nd = (Py_ssize_t)(tag >> _PyLong_NON_SIZE_BITS);
    if ((tag & _PyLong_SIGN_MASK) == 2 || nd > 9)
        return 0;
    const digit *d = l->long_value.ob_digit;
    w[0] = w[1] = w[2] = w[3] = 0;
    for (Py_ssize_t i = 0; i < nd; i++) {
        unsigned bit = 30 * (unsigned)i, j = bit >> 6, sh = bit & 63;
        uint64_t x = d[i];
        w[j] |= x << sh;
        if (sh > 34) {
            uint64_t hi = x >> (64 - sh);
            if (j == 3) {
                if (hi)
                    return 0;
            } else {
                w[j + 1] |= hi;
            }
        }
    }
    return 1;
#elif PY_VERSION_HEX >= 0x030D0000
    Py_ssize_t need = PyLong_AsNativeBytes(
        v, w, 32, Py_ASNATIVEBYTES_LITTLE_ENDIAN |
        Py_ASNATIVEBYTES_UNSIGNED_BUFFER | Py_ASNATIVEBYTES_REJECT_NEGATIVE);
    if (need < 0) {
        PyErr_Clear();
        return 0;
    }
    return need <= 32;
#else
    if (_PyLong_AsByteArray((PyLongObject *)v, (unsigned char *)w, 32, 1,
                            0) < 0) {
        PyErr_Clear();
        return 0;
    }
    return 1;
#endif
}

Py_ssize_t fr_words(PyObject *seq, Py_ssize_t start, Py_ssize_t stop,
                    uint64_t *out) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject **items = PySequence_Fast_ITEMS(seq);
    if (n > stop)
        n = stop;
    for (Py_ssize_t i = start; i < n; i++) {
        PyObject *v = items[i];
        uint64_t *w = out + 4 * i;
        if (!PyLong_CheckExact(v) || !int_words(v, w) || !below_r(w))
            return i;
    }
    return n;
}
