"""The port's quickstart (``altro_tpu_torch/examples/quickstart.py``) on the
CPU at ``--fast``: sections 1-4 (the random-linear MPC through
``make_mpc_step(shared_k=False)`` at B=1, the rocket's cold N=301 solve,
grasp's and the flexible satellite's cold solves), each held to what its
line reports (success, the landing and delivery points, the thrust-angle
and control bounds); section 5 (the closed loop) runs on the card
(``chip_smoke.py`` phase 7). Without a card the default device stops the
run."""
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.examples import quickstart  # noqa: E402

torch.set_num_threads(1)


def _check_random_linear(r):
    assert r["status"] == 1 and r["viol"] <= 1e-4
    assert r["k"] == r["steps"] == 5


def _check_rocket(r):
    assert r["status"] == 1
    assert max(abs(v) for v in r["landed"]) < 1e-3
    assert r["max_angle_deg"] <= 5.0 + 1e-3


def _check_grasp(r):
    assert r["status"] == 1 and r["viol"] <= 1e-5
    assert max(abs(v) for v in r["delivered"]) < 1e-3


def _check_flexsat(r):
    assert r["status"] == 1 and r["max_abs_u"] <= 0.01 + 1e-5


@pytest.mark.parametrize("section, check", [
    (quickstart.random_linear_mpc, _check_random_linear),
    (quickstart.rocket_landing, _check_rocket),
    (quickstart.grasp_transfer, _check_grasp),
    (quickstart.flexsat_regulator, _check_flexsat)],
    ids=["random_linear", "rocket", "grasp", "flexsat"])
def test_quickstart_section_on_cpu(section, check):
    check(section("cpu", fast=True))


def test_quickstart_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        quickstart.main(["--fast"])
