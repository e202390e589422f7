"""``rank1_update``: B_inv += eta row^T on the (rows, m) inverse, one call.

Reads and writes B_inv once, reads eta and the row; one multiply and one
add an element. ``chip_smoke.py``'s count: 8 m^2 + 8 m bytes in float32,
16 m^2 + 16 m in float64 (rows = m).
"""


def nbytes(rows: int, m: int, itemsize: int) -> float:
    return 2.0 * itemsize * rows * m + itemsize * (rows + m)


def flops(rows: int, m: int) -> float:
    return 2.0 * rows * m
