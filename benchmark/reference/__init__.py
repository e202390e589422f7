"""The plain reference of the dense canonical cells and its control.

``simplex64`` works out again, in float64 with plain PyTorch, what the
program's set-up and window derived from A, b and c (the basis's inverse,
x_b, y, the reduced costs, the steepest-edge norms) and judges the
program's answers by it. ``lowprec`` is the control: the same reference
put in the program's place in bfloat16. Neither imports anything of the
program.
"""
