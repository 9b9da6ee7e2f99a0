"""The check on a toy grouped cell: two groups of lanes whose plant and
window problem change with the window and the group (a contact schedule
that switches a group's control columns off and a drift that moves with
both), under shared friction cones, stepped by a toy program built on the
plain reference's pieces (``TrackingMPC``, the barrier solver) in float64.

The cell encodes a lane's group together with its window in ``window_k``,
and starts one window before its first step, not at window 0. The check
reads ``correct`` true where the program propagates every lane in its own
group and window and starts in the cell's start window, and false with each
planted fault: another group's dynamics, the previous window's dynamics,
and a start answered in another window than the one the cell declares for
it. The judgement of the rocket, whose plant is time-invariant, is
bit-equal with and without the window index passed on."""
from __future__ import annotations

import math
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import check, harness, programs, run
from benchmark.reference.ipm import F64
from benchmark.reference.tracking import RowBlock, TrackingMPC
from benchmark.tests._cells import SEED, small_sample, tiny

G, B, N, T = 2, 8, 6, 3            # groups, lanes, knots, steps an episode
START = 2                          # the window before the first step
MU, FZ_MAX, DT = 0.5, 3.0, 0.1
LIMITS = {"x0_err": 2e-5, "cost_gap_p90": 2e-4, "viol_max": 1e-4}
FAULTS = ("other_group", "previous_window", "start_window")


@pytest.fixture(autouse=True)
def one_thread():
    """The toy's many small solves, in one thread (a pool of them is slower
    at these sizes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def window_k(t, lanes):
    """A lane's group and its window at step ``t``, in one index."""
    return (t + 1 + START) * G + lanes % G


def dynamics(window: int, group: int):
    """(A, B, d) of a point mass in a vertical plane, (px, pz, vx, vz),
    pushed by (fx, fz): a group's forces act in every other window, and
    its drift moves with the window and the group."""
    A = torch.eye(4, dtype=torch.float64)
    A[0, 2] = A[1, 3] = DT
    contact = 1.0 if (window + group) % 2 == 0 else 0.0
    Bm = torch.zeros(4, 2, dtype=torch.float64)
    Bm[2, 0] = Bm[3, 1] = DT * contact
    d = torch.tensor([0.0, 0.0, DT * 0.5 * math.cos(window + math.pi * group),
                      -DT * (1.0 + 0.3 * group + 0.1 * window)],
                     dtype=torch.float64)
    return A, Bm, d


class GroupedTracking:
    """The toy's plain reference: per window index (group and window), the
    ``TrackingMPC`` of that group's dynamics in that window, the lanes
    solved key by key."""

    def __init__(self):
        nt = 24
        k = torch.arange(nt, dtype=torch.float64)
        self.X_track = torch.stack([0.1 * k, torch.ones(nt), torch.ones(nt),
                                    torch.zeros(nt)], 1)
        # fx alternates outside the cone |fx| <= MU fz: the cones bind
        self.U_track = torch.stack([0.8 * (-1.0) ** k[:-1],
                                    torch.ones(nt - 1)], 1)
        none = torch.zeros(2, 4, dtype=torch.float64)
        self.blocks = [
            RowBlock("soc", none, torch.tensor([[1.0, 0.0], [0.0, MU]],
                                               dtype=torch.float64),
                     torch.zeros(2, dtype=torch.float64), range(N - 1)),
            RowBlock("nonpos", none[:1], torch.tensor([[0.0, 1.0]],
                                                      dtype=torch.float64),
                     torch.tensor([-FZ_MAX], dtype=torch.float64),
                     range(N - 1))]
        self.models = {}

    def to(self, device):
        return self

    def model(self, key: int) -> TrackingMPC:
        if key not in self.models:
            A, Bm, d = dynamics(key // G, key % G)
            Q = torch.diag(torch.tensor([1.0, 1.0, 0.1, 0.1],
                                        dtype=torch.float64))
            self.models[key] = TrackingMPC(
                A, Bm, d, Q, 0.1 * torch.eye(2, dtype=torch.float64), Q,
                self.X_track, self.U_track, N, self.blocks,
                lambda x, noise, ar: x + 0.01 * noise)
        return self.models[key]

    def _per_key(self, k, fn, *lanes):
        out = None
        for key in torch.unique(k).tolist():
            idx = k == key
            got = fn(self.model(key), key // G, *(a[idx] for a in lanes))
            if out is None:
                out = torch.zeros((k.shape[0],) + got.shape[1:],
                                  dtype=got.dtype)
            out[idx] = got
        return out

    def propagate(self, x0, u0, noise, k, ar=F64):
        return self._per_key(k, lambda mdl, w, x, u, e: mdl.propagate(
            x, u, e, None, ar), x0, u0, noise)

    def solve(self, x0, k, z0, ar=F64, gap_tol=1e-10):
        return self._per_key(k, lambda mdl, w, x, z: mdl.solve(
            x, torch.full((x.shape[0],), w), z, ar, gap_tol), x0, z0)

    def cost(self, x0, U, k):
        return self._per_key(k, lambda mdl, w, x, u: mdl.cost(
            x, u, torch.full((x.shape[0],), w)), x0, U)

    def violation(self, x0, U, k=None):
        return self._per_key(k, lambda mdl, w, x, u: mdl.violation(x, u),
                             x0, U)


def ref_start(L):
    z = torch.zeros(L, N - 1, 2, dtype=torch.float64)
    z[..., 1] = 1.0
    return z


def toy_cell(fault=None) -> programs.Cell:
    """The toy program: each step propagates every lane through its group's
    plant in its window (or, with ``fault``, another's) and solves its
    window's problem; the set-up's carry is every lane's answer in the
    window before the first step."""
    ref = GroupedTracking()
    lanes = torch.arange(B)
    x_start = torch.tensor([0.0, 1.0, 1.0, 0.0])

    def solve(x, k):
        return ref.solve(x.double(), k, ref_start(B), F64,
                         gap_tol=1e-11).float()

    k0 = window_k(0 if fault == "start_window" else -1, lanes)
    carry0 = (x_start.repeat(B, 1), None, solve(x_start.repeat(B, 1), k0))

    def step(carry, noise, t):
        x, _, U = carry
        k = window_k(t, lanes)
        plant = {"other_group": window_k(t, lanes + 1),
                 "previous_window": window_k(t - 1, lanes)}.get(fault, k)
        x_new = ref.propagate(x.double(), U[:, 0].double(), noise.double(),
                              plant).float()
        U_new = solve(x_new, k)
        ones = torch.ones(B, dtype=torch.int32)
        return (x_new, None, U_new), SimpleNamespace(
            x0=x_new, U=U_new, status=ones, iters=ones)
    return programs.Cell(B=B, n=4, m=2, N=N, T=T, carry0=carry0, step=step,
                         window_k=window_k, x0_start=x_start, reference=ref,
                         ref_start=ref_start, success_rate_min=0.999)


def _judged(cell, monkeypatch, tmp_path):
    """A short window of ``cell`` through the harness and the check: the
    result line's object and its stderr lines."""
    wl = harness.Workload(name="toy.grouped", config="toy", spec={},
                          traffic={}, chips=1, limits=LIMITS, end_to_end=[],
                          per_layer=[])
    monkeypatch.setattr(harness, "build_cell", lambda wl, device: cell)
    monkeypatch.setattr(run, "out_dir", lambda args: str(tmp_path))
    args = run.parse(["--workload", wl.name, "--seed", str(SEED),
                      "--seconds", "2.0", "--trace", "0"])
    with small_sample(CHECK_STEPS=6, CHECK_LANES=2):
        res, cell = harness.run_cell(wl, SEED, 2.0, False, device="cpu",
                                     t_start=time.perf_counter(),
                                     out_dir=str(tmp_path))
    assert res.steps >= 1
    return run.assemble(wl, args, res, cell, "cpu", "cpu")


def test_the_window_index_holds_group_and_window():
    lanes = torch.arange(4)
    assert window_k(0, lanes).tolist() == [6, 7, 6, 7]
    assert check.start_window(toy_cell()).tolist() == [START * G]


def test_sound_program_is_correct(monkeypatch, tmp_path):
    out, lines = _judged(toy_cell(), monkeypatch, tmp_path)
    assert out["correct"], lines
    assert out["check"]["x0_err"]["value"] < 1e-6, lines


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_not_correct(fault, monkeypatch, tmp_path):
    out, lines = _judged(toy_cell(fault), monkeypatch, tmp_path)
    assert not out["correct"], lines


class _WindowBlind:
    """The rocket's reference as the check called it before the window
    index reached ``propagate``."""

    def __init__(self, ref):
        self.ref = ref

    def __getattr__(self, name):
        return getattr(self.ref, name)

    def to(self, device):
        return _WindowBlind(self.ref.to(device))

    def propagate(self, x0, u0, noise, k, ar=F64):
        return self.ref.propagate(x0, u0, noise, None, ar)


def test_rocket_judgement_is_unchanged(monkeypatch, tmp_path):
    """The rocket's recorded lane-steps judged with the window index passed
    to ``propagate`` and the start in the cell's start window, and as
    before (no index; the start in window 0): bit-equal."""
    wl = tiny("rocket.track.b1024")
    with small_sample(CHECK_LANES=3):
        res, cell = harness.run_cell(wl, SEED, 1.0, False, device="cpu",
                                     t_start=time.perf_counter(),
                                     out_dir=str(tmp_path))
    assert check.start_window(cell).tolist() == [0]
    now, numbers = check.judge(cell, res.samples, res.start, "cpu")
    monkeypatch.setattr(check, "start_window",
                        lambda cell: torch.zeros(1, dtype=torch.int64))
    monkeypatch.setattr(cell, "reference", _WindowBlind(cell.reference))
    before, numbers_before = check.judge(cell, res.samples, res.start, "cpu")
    for key in ("x0_true", "U_star", "k"):
        assert torch.equal(now[key], before[key]), key
    assert numbers == numbers_before
