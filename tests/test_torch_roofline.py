"""The roofline probe of the port (``altro_tpu_torch/bench/roofline.py``,
``ops/calibrate.py``) against the TPU probe ``tools/exp_r5_roofline.py``:

- the port's four multiply-add counts equal the probe's exactly, over
  n, m in {2, 6, 12, 30, 64}, ladders L in {1, 3, 11} and block lists with
  NONPOS and SOC rows (the probe is loaded from its file; it imports on the
  CPU);
- the calibration's plain version equals a numpy transcription of the
  probe's kernel body (``tools/exp_r5_roofline.py:52-61``: its
  ``pallas_call`` pins TPU memory spaces, has no interpret switch and
  returns only timings) at rows=8, inner=16, streams=16 to 1e-6 relative in
  float32, and the closed form of the recurrence to 1e-12 in float64;
- the kernel's wrapper refuses CPU tensors and malformed arguments; the
  SASS counter reads a listing's loops; the flagship's kernel C inputs roll
  out the states kernel A's do;

and, on a CUDA device, the kernel against its plain version.
"""
import importlib.util
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.bench import roofline  # noqa: E402
from altro_tpu_torch.ops import calibrate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = (2, 6, 12, 30, 64)
LADDERS = (1, 3, 11)
BLOCK_LISTS = ([], [(12, "nonpos")], [(4, "soc")],
               [(3, "zero"), (2, "nonpos"), (4, "soc"), (4, "soc")],
               [(7, "soc"), (24, "nonpos")])


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "exp_r5_roofline", ROOT / "tools" / "exp_r5_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["macs_riccati", "macs_rollout",
                                  "macs_rollout_al", "macs_fused_expansion"])
def test_mac_counts_equal_the_probes(probe, name):
    ours, theirs = getattr(roofline, name), getattr(probe, name)
    for n in WIDTHS:
        for m in WIDTHS:
            if name == "macs_riccati":
                cases = [()]
            elif name == "macs_rollout":
                cases = [(L,) for L in LADDERS]
            elif name == "macs_rollout_al":
                cases = [(L, b) for L in LADDERS for b in BLOCK_LISTS]
            else:
                cases = [(b,) for b in BLOCK_LISTS]
            for extra in cases:
                assert ours(n, m, *extra) == theirs(n, m, *extra), (n, m,
                                                                   extra)


def _probe_body(a, inner, streams):
    """The probe's kernel body (``tools/exp_r5_roofline.py:52-61``) in numpy
    float32: x is a, as the probe reads it."""
    f32 = np.float32
    accs = [a * f32(1.0 + i) for i in range(streams)]
    x = a
    for _ in range(inner):
        for i in range(streams):
            accs[i] = accs[i] * f32(0.999999) + x
    o = accs[0]
    for i in range(1, streams):
        o = o + accs[i]
    return o


def test_plain_calibration_equals_the_probes_body():
    rng = np.random.default_rng(0)
    a = (0.5 + rng.random((8, 128))).astype(np.float32)
    got = calibrate.calibrate_fma_reference(torch.as_tensor(a),
                                            torch.as_tensor(a), 4, 16, 16)
    want = _probe_body(a, 16, 16)
    assert got.dtype == torch.float32 and got.shape == (8, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_plain_calibration_f64_closed_form():
    """acc_i after k rounds is c^k a (1 + i) + x (1 - c^k) / (1 - c); the
    two coefficients are taken in exact rationals of the double c (in
    floating point, 1 - c loses ten digits)."""
    rng = np.random.default_rng(1)
    a, x = rng.random((8, 128)) + 0.5, rng.standard_normal((8, 128))
    k, S = 16, 16
    c = Fraction(calibrate.COEF)
    ck, geo = float(c ** k), float((1 - c ** k) / (1 - c))
    got = calibrate.calibrate_fma_reference(torch.as_tensor(a),
                                            torch.as_tensor(x), 1, k, S)
    want = ck * a * (S * (S + 1) / 2) + S * x * geo
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_kernel_wrapper_refuses_cpu_and_malformed_arguments():
    a = torch.ones((8, 128))
    before = calibrate.launch_count
    with pytest.raises(ValueError, match="CUDA"):
        calibrate.calibrate_fma(a, a, 4, 16, 16)
    with pytest.raises(ValueError, match="streams"):
        calibrate.calibrate_fma_reference(a, a, 4, 16, 3)
    with pytest.raises(ValueError, match="x must match"):
        calibrate.calibrate_fma_reference(a, a.double(), 4, 16, 16)
    with pytest.raises(ValueError, match="grid"):
        calibrate.calibrate_fma_reference(a, a, 0, 16, 16)
    with pytest.raises(ValueError, match="float32 or float64"):
        calibrate.calibrate_fma_reference(a.half(), a.half(), 4, 16, 16)
    assert calibrate.launch_count == before


def test_calibration_work():
    """Three lanes' worth of bytes, and per work item two FLOPs a
    multiply-add plus the first products and the sum."""
    nbytes, flops = roofline.calibrate_work(4096, 512, 16, 1024, 4)
    assert nbytes == 3 * 1024 * 4
    assert flops == 4096 * 1024 * (2 * 512 * 16 + 31)


def _listing(tag, op, unroll, streams, outside=0):
    """A ``cuobjdump -sass`` style listing of one calibrate_fma instance as
    the compiler lays it out: the grid-stride loop in two versions (inner
    at least the unroll: the unrolled loop and a remainder loop of one
    round; else the remainder loop alone), branches to addresses."""
    lines = [f"\t\tFunction : _ZN5altro45_GLOBAL__N__99875da7_12_calibrate_"
             f"cu_e7a11a7313calibrate_fmaI{tag}Li{streams}EEEvPKT_S4_PS2_xii"]
    body = []

    def ins(text):
        body.append(text)
        return 16 * (len(body) - 1)

    def loop(n_fma, tail=()):
        head = ins(f"{op} R4, R4, 0.99999898672103881836, R2")
        for _ in range(n_fma - 1):
            ins(f"{op} R4, R4, 0.99999898672103881836, R2")
        for t in tail:
            ins(t)
        ins(f"@!P0 BRA 0x{head:x}")

    ins("LDC R1, c[0x0][0x28]")
    ins("@!P0 BRA 0xSECOND")
    outer = ins("FMUL R3, R2, 2")
    for _ in range(outside):
        ins(f"{op} R9, R9, R8, R9")
    loop(unroll * streams, ("IADD3 R5, R5, 0x10, RZ",
                            "ISETP.GE.AND P0, PT, R5, R6, PT"))
    loop(streams)
    ins("FADD R7, R4, R5")
    ins(f"@!P0 BRA 0x{outer:x}")
    ins("EXIT")
    second = ins("FMUL R3, R2, 2")
    loop(streams)
    ins(f"@!P0 BRA 0x{second:x}")
    ins("EXIT")
    here = ins("BRA 0xSELF")
    body[-1] = f"BRA 0x{here:x}"
    body[1] = f"@!P0 BRA 0x{second:x}"
    for i, text in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {text} ;"
                     "          /* 0x000fe20000000000 */")
        lines.append(" " * 94 + "/* 0x000fca0000000000 */")
    return "\n".join(lines)


def test_sass_counts_read_a_listing():
    text = "\n".join([_listing("f", "FFMA", 16, 16),
                      _listing("d", "DFMA", 16, 16, outside=1),
                      _listing("f", "FFMA", 8, 4)])
    got = roofline.sass_counts(text, 512 + 5, 16)
    f32, f64 = got["float32"], got["float64"]
    assert (f32["fma_main_loop"], f32["unroll"], f32["one_round_loops"],
            f32["fma_outside_loops"]) == (256, 16, 2, 0)
    assert f32["main_loop_instructions"] == 256 + 3
    assert f32["fma_per_item"] == f32["expected"] == 16 * 517
    assert f64["fma_per_item"] == 16 * 517 + 1     # the stray FMA shows
    assert roofline.sass_counts(text, 7, 16)["float32"]["fma_per_item"] \
        == 16 * 7
    with pytest.raises(RuntimeError, match="calibrate_fma<float32, 8>"):
        roofline.sass_counts(text, 512, 8)


def test_flagship_kernel_c_inputs_roll_out_kernel_a_states():
    """``bench/kernels.py: flagship_inputs``' kernel C arguments (the one
    NONPOS block's merit on kernel A's ladder): the plain C gives the
    plain A's states and controls."""
    from altro_tpu_torch.bench.kernels import flagship_inputs
    from altro_tpu_torch.ops import rollout, rollout_al

    fl = flagship_inputs(torch.float64, torch.device("cpu"), B=3)
    Xs, Us = rollout.batched_ls_rollout(*fl["ladder"])
    got = rollout_al.batched_ls_rollout_al(*fl["ladder_al"],
                                           packed=fl["packed"])
    assert torch.equal(got[0], Xs) and torch.equal(got[1], Us)
    assert got[2].shape == (3, 3)                          # J [B, L]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("streams", [1, 16, 32])
def test_kernel_matches_plain_version(cuda, dtype, tol, streams):
    """inner=64 (4 unrolled passes) and 71 (a remainder of 7 rounds) at a
    grid of 264 steps, a and x positive as the probe's (no cancellation in
    the sum): the fused multiply-adds within the plain version's extra
    rounding."""
    rng = np.random.default_rng(2)
    a, x = (torch.as_tensor(0.5 + rng.random((8, 128)), dtype=dtype,
                            device=cuda) for _ in range(2))
    for inner in (64, 71):
        got = calibrate.calibrate_fma(a, x, 264, inner, streams)
        want = calibrate.calibrate_fma_reference(a, x, 264, inner, streams)
        torch.cuda.synchronize()
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        assert err <= tol, (inner, err)
