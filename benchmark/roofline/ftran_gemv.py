"""The ftran's GEMV: alpha = B_inv a_p on the (m, m) inverse, one call.

Reads B_inv once and the entering column, writes alpha; one multiply and
one add an element of B_inv: itemsize (m^2 + 2 m) bytes, 2 m^2 operations
(rows = m).
"""


def nbytes(m: int, itemsize: int) -> float:
    return float(itemsize) * (m * m + 2 * m)


def flops(m: int) -> float:
    return 2.0 * m * m
