"""The receding-horizon MPC step whose dynamics move with the gait
(``mpc.make_mpc_step(dynamics_fn=...)``) on the quadruped trot's grouped
windows (``models/quadruped/episode.py``), in float64 on the CPU: G=2
groups of 4 lanes, group 1 350 ms ahead in the gait, N=15, 3 steps.

- the grouped step, eagerly and on the fixed-buffer route, equals each
  group stepped alone on its own shared (ungrouped) windows, within 1e-10;
- it agrees with the benchmark's plain reference
  (``benchmark/reference/quadruped.py``): every propagated state within
  1e-10, every lane's cost within the solver's tolerance of the
  reference's optimum;
- the reference's window dynamics (closed-form hover linearization) equal
  the controller's ``_linearized_problem`` at every gait time of a whole
  800 ms trot cycle that the episode reaches (1e-12), and the episode's
  stacks sit at the reference's window keys;
- the per-step cost retarget reproduces ``build_mpc_problem``'s objective
  exactly;
- without ``dynamics_fn`` a compacted shared step's graph inputs and
  finish results are what they were: (carry, noise, Xw, Uw, None) in, (carry,
  results) out.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.constraints import bound_constraint  # noqa: E402
from altro_tpu_torch.costs import retarget_tracking  # noqa: E402
from altro_tpu_torch.dynamics import LTVDynamics  # noqa: E402
from altro_tpu_torch.models import random_linear as trl  # noqa: E402
from altro_tpu_torch.models.quadruped import (config, controller,  # noqa
                                              episode)
from altro_tpu_torch.models.quadruped.gait import GAITS  # noqa: E402
from altro_tpu_torch.mpc import (gen_tracking_mpc, make_mpc_step,  # noqa
                                 make_mpc_step_device_compacted,
                                 track_window)
from altro_tpu_torch.solver.graph import tensors  # noqa: E402

from benchmark.reference import quadruped as ref_quadruped  # noqa: E402

torch.set_num_threads(1)
G, LANES, T, OFFSET_MS = 2, 4, 3, 350
B = G * LANES
SPEC_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "configs",
    "quadruped_trot_N15.json")
F64 = torch.float64


def window_k(t, lanes):
    """The benchmark cell's window index: (t + 1) G + the lane's group."""
    return (t + 1) * G + lanes // LANES


@pytest.fixture(scope="module")
def trot():
    """The configuration at G=2 (offset 350 ms), its port problem and
    windows, the reference, seeded noise, and the grouped step's answers
    (eager) with the carry each step started from."""
    with open(SPEC_FILE) as fh:
        spec = json.load(fh)
    spec = dict(spec, groups=G, phase_offset_ms=OFFSET_MS)
    cfg = config.MPCConfig(linearized_friction=False)
    prob, x_des = controller.build_mpc_problem(cfg, F64)
    windows = episode.trot_windows(cfg, prob, T + 1, G, OFFSET_MS)
    N = cfg.N
    X_track = x_des.expand(N, 12).contiguous()
    U_track = torch.zeros((N - 1, 12), dtype=F64)
    sigma = spec["noise"]["w"] * torch.tensor(spec["noise"]["x0_scale"],
                                              dtype=F64)

    def noise_model(x, e):
        return x + e * sigma

    noise = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (T, B, 12)))
    opts = tt.SolverOptions(**spec["solver"])
    su = dict(spec=spec, cfg=cfg, prob=prob, windows=windows,
              X_track=X_track, U_track=U_track, noise_model=noise_model,
              noise=noise, opts=opts)
    su["eager"] = _run(su, windows, noise, B, graphed=False)
    return su


def _run(su, dynamics_fn, noise, batch, graphed):
    step, init = make_mpc_step(su["prob"], su["opts"], su["X_track"],
                               su["U_track"], noise_model=su["noise_model"],
                               graphed=graphed, dynamics_fn=dynamics_fn)
    carry = init(batch)
    prevs, outs = [], []
    for t in range(T):
        prevs.append(carry)
        carry, out = step(carry, noise[t], t)
        outs.append(out)
    return prevs, outs


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "buffers"])
def test_grouped_step_equals_each_group_alone(trot, graphed):
    w = trot["windows"]
    _, outs = (trot["eager"] if not graphed else
               _run(trot, w, trot["noise"], B, graphed=True))
    for g in range(G):
        def alone(k, g=g):
            return LTVDynamics(A=w.A[k, g], B=w.B[k, g], d=w.d[k, g])
        sl = slice(g * LANES, (g + 1) * LANES)
        _, g_outs = _run(trot, alone, trot["noise"][:, sl], LANES,
                         graphed=graphed)
        for t in range(T):
            assert outs[t].iters[sl].tolist() == g_outs[t].iters.tolist()
            assert outs[t].status[sl].tolist() == g_outs[t].status.tolist()
            for f in ("x0", "U", "X"):
                np.testing.assert_allclose(
                    getattr(outs[t], f)[sl].numpy(),
                    getattr(g_outs[t], f).numpy(), atol=1e-10, rtol=0)
    assert all(bool((o.status == 1).all()) for o in outs)


def test_step_agrees_with_the_plain_reference(trot):
    ref = ref_quadruped.TrotReference(trot["spec"])
    prevs, outs = trot["eager"]
    lanes = torch.arange(B)
    tol = trot["opts"].cost_tolerance
    for t in range(T):
        x_prev, _, U_prev, _ = prevs[t]
        k = window_k(t, lanes)
        x0 = ref.propagate(x_prev, U_prev[:, 0], trot["noise"][t], k)
        np.testing.assert_allclose(outs[t].x0.numpy(), x0.numpy(),
                                   atol=1e-10, rtol=0)
        U_star = ref.solve(x0, k, ref.hover(B), gap_tol=1e-11)
        J_star = ref.cost(x0, U_star, k)
        J = ref.cost(x0, outs[t].U, k)
        gap = (J - J_star).abs() / torch.clamp(J_star.abs(), min=1.0)
        assert float(gap.max()) <= tol, (t, gap)
        assert float(ref.violation(x0, outs[t].U, k).max()) <= \
            trot["opts"].constraint_tolerance


def test_reference_windows_equal_the_controllers(trot):
    """Every gait time of a trot cycle the episode reaches (multiples of
    10 ms: steps of 30 ms, offsets of 50 ms): the reference's contact
    flags are the episode's and its closed-form linearization the
    controller's; and the episode's stacks are at the reference's keys."""
    cfg, prob = trot["cfg"], trot["prob"]
    ref = ref_quadruped.TrotReference(trot["spec"])
    gait = GAITS["trot"](cfg.stance_time, cfg.swing_time)
    x_des = prob.x0
    feet = episode.stance_feet(x_des).expand(cfg.N, 4, 3)
    for t_ms in range(0, 800, 10):
        contacts = episode.contacts_ms(gait, t_ms, cfg.N, 30)
        assert torch.equal(ref.contacts(t_ms), contacts), t_ms
        dyn = controller._linearized_problem(
            prob, x_des, x_des.expand(cfg.N, 12), contacts, feet,
            cfg.dynamics_discretization).dynamics
        for got, want in zip(ref.linearized(contacts), (dyn.A, dyn.B,
                                                        dyn.d)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       atol=1e-12, rtol=0)
    w = trot["windows"]
    keys = torch.arange((T + 1) * G)
    for name, stack in zip(("A", "B", "d"), ref.stacks(keys)):
        np.testing.assert_allclose(
            getattr(w, name).flatten(0, 1).numpy(), stack.numpy(),
            atol=1e-12, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_retarget_reproduces_the_controllers_cost(dtype):
    cfg = config.MPCConfig(linearized_friction=False)
    prob, x_des = controller.build_mpc_problem(cfg, dtype)
    N = cfg.N
    Xw, Uw = track_window(x_des.expand(N, 12),
                          torch.zeros((N - 1, 12), dtype=dtype), 7, N)
    cost = retarget_tracking(prob.cost, Xw, Uw)
    for f in dataclasses.fields(cost):
        assert torch.equal(getattr(cost, f.name),
                           getattr(prob.cost, f.name)), f.name


def test_fixed_dynamics_keep_the_compacted_steps_inputs():
    n, m, N, batch = 4, 2, 6, 4
    prob = trl.gen_random_linear(np.random.default_rng(3), n, m, N + 4)
    X_t, U_t = trl.gen_trajectory(np.random.default_rng(4), prob, N + 4)
    prob = dataclasses.replace(prob, constraints=(bound_constraint(
        N + 4, n, m, u_min=-0.5, u_max=0.5, dtype=F64),))
    pm = gen_tracking_mpc(prob, X_t, U_t, N)
    step, init = make_mpc_step_device_compacted(
        pm, tt.SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                             iterations_linesearch=2),
        X_t, U_t, it_cap=1, block=2, graphed=True)
    carry = init(batch)
    noise = torch.zeros((batch, n), dtype=F64)
    carry1, out = step(carry, noise, 0)
    assert step.pieces.dyn_inputs == 0 and step.pieces.groups == 0
    g = step.sets[batch]
    Xw, Uw = track_window(X_t, U_t, 1, N)
    assert len(g.inputs) == 5 and g.inputs[4] is None
    want = tensors((carry, noise, Xw, Uw))
    have = tensors(g.inputs)
    assert [t.shape for t in have] == [t.shape for t in want]
    assert g.dyn_bytes == 0
    assert len(g.finish.out) == 2
    assert len(tensors(g.finish.out)) == len(tensors((carry1, out)))
