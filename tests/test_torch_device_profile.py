"""The device profile's windows (``altro_tpu_torch/bench/device_profile.py``)
on the CPU at a small batch: each path's window runs warm work through the
solver and counts its solver-loop passes, and device kernels are sorted
into the kinds the profile reports. The profile itself needs a CUDA device."""
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.bench import device_profile as dp  # noqa: E402

torch.set_num_threads(1)


def test_flagship_window_counts_iterations():
    window = dp.flagship_window(B=4, device="cpu")
    first, second = window(), window()
    assert first >= dp.FLAG_STEPS and second >= dp.FLAG_STEPS


def test_flagship_lanes_window_counts_iterations():
    """The flagship with a window index per lane: every step runs at least
    one solver-loop pass; kernel B's wrapper is never called (the split
    route)."""
    from altro_tpu_torch.ops import riccati_fused
    b0 = riccati_fused.launch_count
    window = dp.flagship_lanes_window(B=5, device="cpu")
    assert window() >= dp.FLAG_STEPS
    assert riccati_fused.launch_count == b0


@pytest.mark.parametrize("linearized", [True, False], ids=["qp", "socp"])
def test_quadruped_window_counts_iterations(linearized):
    window = dp.quadruped_window(linearized, B=8, device="cpu")
    assert window() >= dp.QUAD_SOLVES


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compacted"])
def test_grasp_window_counts_passes(compact):
    """Grasp's window on the CPU at B=8, plain and in its shipped schedule
    (the blocks of 256 and 128 clamp to the batch): every step runs at
    least one solver-loop pass."""
    window = dp.conic_window("grasp", compact, B=8, device="cpu")
    assert window() >= dp.GRASP_STEPS


def test_grasp_split_window_counts_passes():
    """Grasp's plain window with the fused expansion off (the split
    route's profile path) at B=8 on the CPU."""
    window = dp.conic_window("grasp", False, B=8, device="cpu", split=True)
    assert window() >= dp.GRASP_STEPS


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::riccati_kernel<float, 64, 12>(float "
     "const*)", "kernel D (riccati)"),
    ("void (anonymous namespace)::ls_rollout_al_kernel<float, 16, 1>(float "
     "const*)", "kernel C (ls_rollout_al)"),
    ("void (anonymous namespace)::ls_rollout_kernel<float, 16>(float const*)",
     "kernel A (ls_rollout)"),
    ("void (anonymous namespace)::fused_expand_backward_kernel<float, 64, 6>",
     "kernel B (fused_expand_backward)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AddFunctor<float>>", "elementwise"),
    ("Memset (Device)", "other"),
])
def test_kernel_names_sort_into_kinds(name, kind):
    assert dp.kind_of(name) == kind


def test_graphed_grasp_window_counts_passes():
    """Grasp's compacted window on the fixed-buffer route (the graphed form
    on the CPU, B=8): the step keeps its loop graphs per level batch, and
    every step runs at least one pass per loop entry."""
    window = dp.conic_window("grasp", True, B=8, device="cpu", graphed=True)
    assert window() >= 5 * dp.GRASP_STEPS
    (levels,) = window.step.sets.values()
    assert [loop.state[0].shape[0] for loop in levels.loops] == [8, 8, 8]


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compacted"])
def test_flexsat_window_counts_passes(compact):
    """Flexsat's window on the CPU at B=8, plain and in its shipped
    schedule (the blocks clamp to the batch): every regulator step runs at
    least one solver-loop pass."""
    window = dp.flexsat_window(compact, B=8, device="cpu")
    assert window() >= dp.FLEX_STEPS
