"""The port's copy of the JAX package's native C++ oracles (dense ADMM QP
and conic solvers, knot-structured ADMM, AL-iLQR) and their ctypes
binding, built with g++ at first use (:mod:`.qp`)."""
from .qp import NativeQPSolution, available, solve_conic, solve_qp
