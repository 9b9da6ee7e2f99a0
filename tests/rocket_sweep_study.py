"""The rocket tolerance sweep, the port against the JAX package in float64
on the CPU: a study script behind ``tests/test_torch_lockstep.py``'s sweep
tests (not collected by pytest).

    env -u PYTHONPATH JAX_PLATFORMS=cpu python -m tests.rocket_sweep_study \\
        steps [--eager] TOL...
    env -u PYTHONPATH JAX_PLATFORMS=cpu python -m tests.rocket_sweep_study \\
        trace TOL STEP

Both packages get the JAX package's cold N=301 solve and MPC window
(converted, so the problem data are bit-equal) and the same noise.

``steps`` prints, per step of the T=20 sweep at each tolerance, the
iterations of the JAX package's jitted step, of the port's step from the
JAX package's carry before that step (converted), and of the port run free
on its own carry, with max|U| between the JAX step and the port's step
from its carry. ``--eager`` adds the JAX package run free op by op
(``jax.disable_jit``, slow: ~10 s per step) and max|U| between it and the
free port.

``trace`` runs both packages free op by op up to step STEP, starts both
from the JAX package's carry there, and prints per solver iteration the
AL cost, regularization, gradient, violation and round counters of both
(the first iteration whose decisions differ, and by how much the deciding
quantities differ).
"""
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

import altro_tpu as at  # noqa: E402
from altro_tpu.models import rocket as jrocket  # noqa: E402
from altro_tpu.mpc import gen_tracking_mpc as jgen  # noqa: E402
from altro_tpu.mpc import make_mpc_step as jmake  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.convert import (numpy_tree,  # noqa: E402
                                     problem_from_numpy)
from altro_tpu_torch.models import rocket  # noqa: E402
from altro_tpu_torch.mpc import make_mpc_step  # noqa: E402

T = 20


def setup():
    N = 301
    jp = jrocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    cold = jax.jit(at.solve)(jp, at.SolverOptions(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-5, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100),
        U0=jrocket.hover_controls(jp))
    jpm = jgen(jp, cold.X, cold.U, 21, dt=0.05)
    return dict(jpm=jpm, cold=cold, tpm=problem_from_numpy(numpy_tree(jpm)),
                Xc=torch.tensor(np.asarray(cold.X)),
                Uc=torch.tensor(np.asarray(cold.U)),
                noise=np.random.default_rng(1).standard_normal((T, 6)))


def opts(mod, tol):
    return mod.SolverOptions(
        cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
        constraint_tolerance=tol, penalty_initial=1e3, penalty_scaling=10.0,
        reset_duals=False, iterations_outer=40)


def to_port(carry):
    def t(a):
        return torch.tensor(np.asarray(a))[None]
    x0, X, U, duals = carry[:4]
    return (t(x0), t(X), t(U),
            tuple(tt.DualState(lam=t(d.lam), rho=t(d.rho)) for d in duals))


def steps(d, tol, eager):
    jstep, jinit = jmake(d["jpm"], opts(at, tol), d["cold"].X, d["cold"].U,
                         jrocket.rocket_noise_model())
    jjit = jax.jit(jstep)
    carry = jax.jit(jinit)()
    step, _ = make_mpc_step(d["tpm"], opts(tt, tol), d["Xc"], d["Uc"],
                            rocket.rocket_noise_model(), graphed=False)
    own, ecarry = to_port(carry), carry
    print(f"tol {tol:g}: step, iterations of the JAX step / the port from "
          "the JAX carry / the port free" + (" / JAX op by op free" if eager
                                             else ""))
    for t in range(T):
        noise = d["noise"][t]
        _, out = step(to_port(carry), torch.tensor(noise)[None], t)
        carry, jout = jjit(carry, jnp.asarray(noise))
        own, oout = step(own, torch.tensor(noise)[None], t)
        du = float(np.abs(np.asarray(jout.U) - out.U[0].numpy()).max())
        line = (f"  {t}: {int(jout.iters)} / {int(out.iters[0])} / "
                f"{int(oout.iters[0])}")
        if eager:
            with jax.disable_jit():
                ecarry, eout = jstep(ecarry, jnp.asarray(noise))
            de = float(np.abs(np.asarray(eout.U) - oout.U[0].numpy()).max())
            line += (f" / {int(eout.iters)}; max|U op by op - port free| "
                     f"{de:.2e}")
        print(line + f"; max|U jit - port from carry| {du:.2e}", flush=True)


def trace(d, tol, step_k):
    from altro_tpu.costs import retarget_tracking
    from altro_tpu.mpc import _xws_corrector, shift_fill, track_window
    from altro_tpu.solver import altro as jal
    from altro_tpu_torch.mpc import _StepPieces
    from altro_tpu_torch.solver import altro as tal
    jo, to = opts(at, tol), opts(tt, tol)
    jstep, jinit = jmake(d["jpm"], jo, d["cold"].X, d["cold"].U,
                         jrocket.rocket_noise_model())
    carry = jax.jit(jinit)()
    with jax.disable_jit():
        for t in range(step_k):
            carry, _ = jstep(carry, jnp.asarray(d["noise"][t]))
    x0, X, U, duals, k = carry
    jpm = d["jpm"]
    x0_new = jrocket.rocket_noise_model()(
        jpm.dynamics.step(x0, U[0], 0), jnp.asarray(d["noise"][step_k]))
    Xw, Uw = track_window(d["cold"].X, d["cold"].U, int(k) + 1, 21)
    jpk = jpm.replace(cost=retarget_tracking(jpm.cost, Xw, Uw), x0=x0_new)
    U_ws = shift_fill(U)
    js = jal._warmstart_state(jpk, jo, U_ws, tuple(x.shift() for x in duals),
                              _xws_corrector(jpm.dynamics)(X, U_ws, x0_new))
    pieces = _StepPieces(d["tpm"], to, d["Xc"], d["Uc"],
                         rocket.rocket_noise_model(), None, "shift")
    tpk, ts, _ = pieces.start_from(to_port(carry),
                                   torch.tensor(d["noise"][step_k])[None],
                                   *pieces.window(step_k + 1))
    jcond, jbody = jal.loop_fns(jpk, jo, js)
    _, tcond, tbody = tal.loop_fns(tpk, to, ts)

    def cost(s, port):
        if port:
            return float(tal.total_al_cost_res(tpk, s[3], s[0], s[1])[0][0])
        return float(jal.total_al_cost(jpk, s[3], s[0], s[1]))
    for it in range(1, 100):
        if not bool(jcond(js)) and not bool(tcond(ts)[0]):
            break
        with jax.disable_jit():
            js = jbody(js)
        ts = tbody(ts)
        print(f"  iteration {it}: J {cost(js, False):.17g} / "
              f"{cost(ts, True):.17g}; reg {float(js[4]):.1e} / "
              f"{float(ts[4][0]):.1e}; grad {float(js[5]):.6e} / "
              f"{float(ts[5][0]):.6e}; viol {float(js[6]):.3e} / "
              f"{float(ts[6][0]):.3e}; rounds {int(js[9])} / "
              f"{int(ts[9][0])}; done {bool(js[10])} / {bool(ts[10][0])}",
              flush=True)


def main():
    torch.set_num_threads(1)
    d = setup()
    if sys.argv[1] == "steps":
        eager = "--eager" in sys.argv
        for tol in (float(a) for a in sys.argv[2:] if a != "--eager"):
            steps(d, tol, eager)
    else:
        trace(d, float(sys.argv[2]), int(sys.argv[3]))


if __name__ == "__main__":
    main()
