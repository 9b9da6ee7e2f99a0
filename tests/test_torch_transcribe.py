"""The port's batch transcription against the JAX package's in float64 on the
CPU: ``to_batch_qp``, ``to_batch_conic`` and ``to_knot_qp`` to 1e-12 (the
same infinite bounds, the same cone segments) on the random-linear MPC
problem (n=12, m=6, N=11), the rocket window (N=21, three SOC blocks), the
grasp window (N=11 at knot 3 of the N=61 problem: torque balance, max
force, two friction cones) and the quadruped's per-lane linearization (two
contact schedules as two lanes of one batch, in both friction models); the
four in-place refreshers; and both packages refusing a nonlinear block
(the quadratic norm block) and nonlinear dynamics.
Each package builds its problems from the same seeds and numpy arrays.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from altro_tpu import transcribe as jtr  # noqa: E402
from altro_tpu.mpc import gen_tracking_mpc as jgen  # noqa: E402
from altro_tpu.solver import knot_admm as jknot  # noqa: E402

from altro_tpu_torch import transcribe as ttr  # noqa: E402
from altro_tpu_torch.constraints import (  # noqa: E402
    quad_norm_constraint as tquad_norm_constraint)
from altro_tpu_torch.dynamics import NonlinearDynamics as TNonlinear  # noqa: E402,E501
from altro_tpu_torch.mpc import gen_tracking_mpc as tgen  # noqa: E402
from altro_tpu_torch.solver import knot_admm as tknot  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-12
# the JAX package's transcriptions, jitted: one compile per structure, not
# one per eager op
J_QP, J_CONIC, J_KNOT = (jax.jit(jtr.to_batch_qp), jax.jit(jtr.to_batch_conic),
                         jax.jit(jknot.to_knot_qp))


def _close(a, b, what):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape, (what, a.shape, b.shape)
    inf_a, inf_b = np.isinf(a), np.isinf(b)
    assert (inf_a == inf_b).all() and (a[inf_a] == b[inf_b]).all(), what
    err = np.abs(np.where(inf_a, 0.0, a) - np.where(inf_b, 0.0, b)).max() \
        if a.size else 0.0
    assert err <= TOL, (what, err)


@functools.lru_cache(maxsize=None)
def _random_linear():
    from altro_tpu.models import random_linear as jrl
    from altro_tpu_torch.models import random_linear as trl
    out = []
    for rl in (jrl, trl):
        rng = np.random.default_rng(1)
        p = rl.gen_random_linear(rng, 12, 6, 30)
        X, U = rl.gen_trajectory(rng, p, 30)
        out.append(rl.gen_tracking_mpc(p, X, U, 11))
    return out


def _window(jprob, tprob, N_track, n, m, N_mpc, **kw):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((N_track, n))
    U = rng.standard_normal((N_track - 1, m))
    return (jgen(jprob, jnp.asarray(X), jnp.asarray(U), N_mpc, **kw),
            tgen(tprob, torch.tensor(X), torch.tensor(U), N_mpc, **kw))


def _rocket():
    from altro_tpu.models import rocket as jr
    from altro_tpu_torch.models import rocket as trk
    return _window(jr.rocket_problem(N=301, tf=15.0),
                   trk.rocket_problem(N=301, tf=15.0), 301, 6, 3, 21,
                   dt=0.05)


def _grasp():
    from altro_tpu.models import grasp as jg
    from altro_tpu_torch.models import grasp as tg
    N, tf, N_mpc, k0 = 61, 6.0, 11, 3
    jo, to = jg.make_grasp_object(N, tf), tg.make_grasp_object(N, tf)
    jp, tp = _window(jg.grasp_problem(jo, N, tf), tg.grasp_problem(to, N, tf),
                     N, 6, 6, N_mpc, Qk=1e3, Rk=1.0, Qfk=10.0,
                     dt=tf / (N - 1))
    return (jp.replace(constraints=jg.grasp_constraints(jo, N_mpc, k0)),
            dataclasses.replace(tp, constraints=tg.grasp_constraints(
                to, N_mpc, k0)))


def _quadruped(lin):
    """Two schedules (t = 0.05 s and 0.3 s from two perturbed stances):
    a list of the JAX package's two problems, and the port's batch of two
    lanes with per-lane dynamics."""
    from altro_tpu.models.quadruped import config as jc
    from altro_tpu.models.quadruped import controller as jctl
    from altro_tpu.models.quadruped import gait as jgait
    from altro_tpu.models.quadruped import planner as jpl
    from altro_tpu_torch.models.quadruped import config as tc
    from altro_tpu_torch.models.quadruped import controller as tctl
    from altro_tpu_torch.models.quadruped import gait as tgait
    from altro_tpu_torch.models.quadruped import planner as tpl

    jcfg, tcfg = (jc.MPCConfig(linearized_friction=lin),
                  tc.MPCConfig(linearized_friction=lin))
    jprob, jx = jctl.build_mpc_problem(jcfg)
    tprob, tx = tctl.build_mpc_problem(tcfg, device="cpu")
    jg = jgait.trot(jcfg.stance_time, jcfg.swing_time)
    tg = tgait.GAITS[tcfg.gait_type](tcfg.stance_time, tcfg.swing_time)
    jps, dyns, x0s = [], [], []
    for seed, t in ((3, 0.05), (4, 0.3)):
        dx = np.random.default_rng(seed).standard_normal(12) * 0.01
        jfeet = jpl.nominal_foot_locations() + jx[0:3][None, :]
        c, f, _ = jax.jit(jpl.foot_history, static_argnums=(6, 7))(
            t, jnp.tile(jx, (jcfg.N, 1)), jfeet, jfeet, jg, jx, jcfg.N,
            jcfg.dynamics_discretization)
        jps.append(jax.jit(jctl._linearized_problem, static_argnums=5)(
            jprob, jx + jnp.asarray(dx), jnp.tile(jx, (jcfg.N, 1)), c, f,
            jcfg.dynamics_discretization))
        tfeet = tpl.nominal_foot_locations() + tx[0:3][None, :]
        c, f, _ = tpl.foot_history(torch.tensor(t, dtype=torch.float64),
                                   tx.expand(tcfg.N, 12), tfeet, tfeet, tg,
                                   tx, tcfg.N, tcfg.dynamics_discretization)
        tp = tctl._linearized_problem(tprob, tx + torch.tensor(dx),
                                      tx.expand(tcfg.N, 12), c, f,
                                      tcfg.dynamics_discretization)
        dyns.append(tp.dynamics)
        x0s.append(tp.x0)
    dyn = type(dyns[0])(**{k: torch.stack([getattr(d, k) for d in dyns])
                           for k in ("A", "B", "d")})
    return jps, dataclasses.replace(tprob, dynamics=dyn,
                                    x0=torch.stack(x0s))


def _compare(jprog, tprog, lane, fields):
    for k in fields:
        _close(getattr(jprog, k), getattr(tprog, k)[lane], k)
    assert (jprog.n, jprog.m, jprog.N) == (tprog.n, tprog.m, tprog.N)


def _compare_knot(jk, tk, lane):
    for k in ("Q", "q", "R", "r", "A", "B", "d", "x0"):
        _close(getattr(jk, k), getattr(tk, k)[lane], k)
    for k in ("Cx", "Cu", "l", "u"):
        assert len(getattr(jk, k)) == len(getattr(tk, k))
        for i, (a, b) in enumerate(zip(getattr(jk, k), getattr(tk, k))):
            _close(a, b[lane], f"{k}{i}")
    assert [c.value for c in jk.cones] == [c.value for c in tk.cones]


def _segments(s):
    return [(c.value, int(n)) for c, n in s]


@pytest.mark.parametrize("name", ["random_linear", "rocket", "grasp",
                                  "quadruped_qp", "quadruped_socp"])
def test_transcriptions_match_jax(name):
    if name.startswith("quadruped"):
        jps, tp = _quadruped(name == "quadruped_qp")
    else:
        jp, tp = {"random_linear": _random_linear, "rocket": _rocket,
                  "grasp": _grasp}[name]()
        jps = [jp]
    soc = any(c.cone.value == "soc" for c in tp.constraints)
    tknq = tknot.to_knot_qp(tp)
    if not soc:
        tq = ttr.to_batch_qp(tp)
        assert tq.P.shape[0] == len(jps)
    tc = ttr.to_batch_conic(tp)
    for lane, jp in enumerate(jps):
        if not soc:
            _compare(J_QP(jp), tq, lane, "PqAlu")
        jc = J_CONIC(jp)
        _compare(jc, tc, lane, ("P", "q", "A", "b"))
        assert _segments(jc.segments) == _segments(tc.segments)
        _compare_knot(J_KNOT(jp), tknq, lane)
    if soc:
        with pytest.raises(ValueError, match="SOC"):
            ttr.to_batch_qp(tp)


def test_refreshers_match_jax():
    """qp_set_x0 / qp_set_cost / conic_set_x0 / conic_set_cost on the
    random-linear QP after a window advance, against the JAX package's."""
    from altro_tpu.costs import retarget_tracking as jret
    from altro_tpu_torch.costs import retarget_tracking as tret
    jp, tp = _random_linear()
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal(12)
    Xw, Uw = rng.standard_normal((11, 12)), rng.standard_normal((10, 6))
    jp2 = jp.replace(cost=jret(jp.cost, jnp.asarray(Xw), jnp.asarray(Uw)))
    tp2 = dataclasses.replace(tp, cost=tret(tp.cost, torch.tensor(Xw),
                                            torch.tensor(Uw)))
    jq, tq = jtr.to_batch_qp(jp), ttr.to_batch_qp(tp)
    _compare(jtr.qp_set_x0(jq, jnp.asarray(x0)),
             ttr.qp_set_x0(tq, torch.tensor(x0)[None]), 0, "PqAlu")
    _compare(jtr.qp_set_cost(jq, jp2), ttr.qp_set_cost(tq, tp2), 0, "PqAlu")
    jc, tc = jtr.to_batch_conic(jp), ttr.to_batch_conic(tp)
    fields = ("P", "q", "A", "b")
    _compare(jtr.conic_set_x0(jc, jnp.asarray(x0)),
             ttr.conic_set_x0(tc, torch.tensor(x0)[None]), 0, fields)
    _compare(jtr.conic_set_cost(jc, jp2), ttr.conic_set_cost(tc, tp2), 0,
             fields)
    # the refreshed rows equal a fresh transcription from the new x0
    fresh = ttr.to_batch_qp(dataclasses.replace(
        tp2, x0=torch.tensor(x0)[None]))
    set_both = ttr.qp_set_cost(ttr.qp_set_x0(tq, torch.tensor(x0)[None]),
                               tp2)
    for k in "PqAlu":
        assert torch.equal(getattr(fresh, k), getattr(set_both, k)), k


def test_both_packages_refuse_a_nonlinear_block():
    jp, tp = _random_linear()
    from altro_tpu.constraints import quad_norm_constraint
    jblk = quad_norm_constraint(jp.N, jp.n, jp.m, jnp.eye(jp.m), offset=1.0)
    jbad = jp.replace(constraints=jp.constraints + (jblk,))
    tblk = tquad_norm_constraint(tp.N, tp.n, tp.m,
                                 torch.eye(tp.m, dtype=torch.float64),
                                 offset=1.0)
    tbad = dataclasses.replace(tp, constraints=tp.constraints + (tblk,))
    for fn in (jtr.to_batch_qp, jtr.to_batch_conic, jknot.to_knot_qp):
        with pytest.raises(TypeError):
            fn(jbad)
    for fn in (ttr.to_batch_qp, ttr.to_batch_conic, tknot.to_knot_qp):
        with pytest.raises(TypeError, match="nonlinear"):
            fn(tbad)


def test_both_packages_refuse_nonlinear_dynamics():
    """A nonlinear model (the random-linear model's own step as a function
    of one lane) is refused by every transcription of both packages: they
    take LTV stacks only (relinearize first)."""
    jp, tp = _random_linear()
    from altro_tpu.dynamics import NonlinearDynamics as JNonlinear

    def jf(params, x, u, k):
        A, B = params
        return A[k] @ x + B[k] @ u

    def tf(params, x, u, k):
        A, B = params
        return A[k] @ x + B[k] @ u
    jbad = jp.replace(dynamics=JNonlinear(
        f=jf, params=(jp.dynamics.A, jp.dynamics.B), n_=jp.n, m_=jp.m,
        N_=jp.N))
    tbad = dataclasses.replace(tp, dynamics=TNonlinear(
        f=tf, params=(tp.dynamics.A, tp.dynamics.B), n_=tp.n, m_=tp.m,
        N_=tp.N))
    for fn in (jtr.to_batch_qp, jtr.to_batch_conic, jknot.to_knot_qp):
        with pytest.raises(TypeError, match="LTVDynamics"):
            fn(jbad)
    for fn in (ttr.to_batch_qp, ttr.to_batch_conic, tknot.to_knot_qp):
        with pytest.raises(TypeError, match="LTVDynamics"):
            fn(tbad)
