"""Numerical ops and the hand-written Hopper kernels' wrappers."""
