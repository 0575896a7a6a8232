"""Frequent Directions, blocking and pools, the preconditioner engine,
Sketchy and the optimizer chain."""
