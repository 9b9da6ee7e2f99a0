"""Solver: the batched augmented-Lagrangian iLQR loop and its options."""
from .altro import Solution, Stats, solve, solve_partial, solve_resume
from .options import SolverOptions
