"""``pricing_scan``: the pricing pass with its mask and choice, one call.

Reads A's (m, cols) block once (the whole A, or the rank's column shard),
y and the basis (m each), c (cols), and writes the choice (four words);
two operations an element of A. ``chip_smoke.py``'s count:
4 (m cols + 2 m + cols) + 16 bytes in float32, 8 (m cols + 2 m + cols)
+ 4 m + 24 in float64.
"""


def nbytes(m: int, cols: int, itemsize: int) -> float:
    if itemsize == 8:
        return 8.0 * (m * cols + 2 * m + cols) + 4 * m + 24
    return 4.0 * (m * cols + 2 * m + cols) + 16


def flops(m: int, cols: int) -> float:
    return 2.0 * m * cols
