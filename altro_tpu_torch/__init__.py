"""altro_tpu_torch: the PyTorch and CUDA port of altro_tpu.

The augmented-Lagrangian iLQR solver with ZERO, NONPOS and second-order-cone
constraint blocks and nonlinear quadratic norm blocks, on LTV or nonlinear
dynamics (linearized per lane by forward-mode autodiff), its warm-started
receding-horizon MPC step (plain or with straggler compaction) and the
random-linear, rocket soft-landing, grasp and quadruped trot benchmark
models, batched over scenarios (with shared or
per-scenario dynamics), with
hand-written Hopper kernels for the fused AL expansion + Riccati backward
pass, the Riccati backward pass from a per-scenario expansion, the
line-search ladder rollout and the ladder rollout fused with the AL merit
(``csrc/``). On a CUDA device a solve's start, loop and finish run as CUDA
graphs, replayed with one host sync per loop pass (``solver/graph.py``;
``graphed=False`` keeps the host-driven loop). Beside the solver: the
in-framework baseline oracles (``transcribe.py``; the dense QP, dense
conic and knot-structured ADMM solvers under ``solver/``, their chunks on
CUDA graphs), the ALTRO-vs-baseline lockstep loops (``mpc.py``) and the
paper's benchmark drivers (``bench/drivers.py``). The JAX package ``altro_tpu``
is the reference it is checked against; this package imports neither it
nor JAX.

Importing the package pins float32 matrix products to full precision (no
TF32): the solver's tolerances assume it, as the JAX package pins its
matmuls away from bf16.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .cones import Cone  # noqa: E402
from .constraints import (  # noqa: E402
    ConicConstraint,
    DualState,
    QuadNormConstraint,
    bound_constraint,
    friction_cone,
    goal_constraint,
    linear_constraint,
    linearized_friction,
    norm_constraint,
    norm_constraint2,
    quad_norm_constraint,
)
from .costs import (  # noqa: E402
    QuadCost,
    lqr_objective,
    retarget_tracking,
    tracking_objective,
)
from .dynamics import (  # noqa: E402
    LTVDynamics,
    NonlinearDynamics,
    euler_discretize,
    lti_dynamics,
    rk4,
    zoh_discretize,
)
from .problem import Problem  # noqa: E402
from .solver.altro import (  # noqa: E402
    Solution,
    Stats,
    check_status,
    print_summary,
    solve,
    solve_partial,
    solve_resume,
)
from .solver.options import SolverOptions  # noqa: E402

__version__ = "0.1.0"
