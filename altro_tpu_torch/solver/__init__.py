"""Solver: the batched augmented-Lagrangian iLQR loop and its options."""
from .altro import Solution, Stats, solve
from .options import SolverOptions
