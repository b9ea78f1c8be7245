"""Plain references, one module per algorithm: ``expected(arcs, params)``
from the generated arcs alone, ``answer(state, slot, n_pad)`` reading the
program's output, and ``compare(expected, answer)`` giving each number
that the cell's limits hold.  Plain PyTorch and NumPy; nothing of the
program is imported."""
