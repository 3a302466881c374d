"""Plain tensor ops and the hand-written kernels (``ops.kernels``)."""
