"""The plain reference against hand-worked cases, and its polynomial against
the program's own construction (read here only to show both derive the
same circuit; the reference imports nothing of the program)."""

import math

import numpy as np
import pytest
import torch

from portbench import check
from portbench.reference import matching as ref


def test_f4_and_step_on_hand_worked_points():
    one = torch.tensor([1.0, -1.0, 0.0, 0.5], dtype=torch.float64)
    # f4(1) = (315 - 420 + 378 - 180 + 35) / 128 = 1; odd, so f4(-1) = -1
    f4 = ref.power_eval(one, ref.F4_COEFS)
    assert f4.tolist()[:3] == pytest.approx([1.0, -1.0, 0.0])
    x = 0.5
    assert float(f4[3]) == pytest.approx(
        (315 * x - 420 * x ** 3 + 378 * x ** 5 - 180 * x ** 7 + 35 * x ** 9) / 128)
    # degree 1 at nodes cos(pi/4) = +-0.7071 around a threshold of 0: the
    # step reads +1 / -1 there, so c_0 = 0 and c_1 = 2/2 (1 * 0.7071 +
    # -1 * -0.7071) = sqrt(2)
    c = ref.step_coefficients(0.0, 1)
    assert c.tolist() == pytest.approx([0.0, math.sqrt(2.0)])
    assert ref.chebyshev_eval(torch.tensor([0.5], dtype=torch.float64), [0.3, 0.0, 2.0]
                              ).item() == pytest.approx(0.3 + 2.0 * (2 * 0.25 - 1))


def test_chebyshev_eval_agrees_with_numpy():
    c = ref.step_coefficients(0.44, ref.DEPTH_TO_DEGREE[10])
    x = np.linspace(-1.0, 1.0, 1001)
    got = ref.chebyshev_eval(torch.from_numpy(x), c.tolist()).numpy()
    assert np.allclose(got, np.polynomial.chebyshev.chebval(x, c.numpy()), atol=1e-12)


def test_coefficients_equal_the_programs_construction():
    from image_matching_tpu_torch.ckks import poly_eval

    for depth in (8, 9, 10):
        deg = ref.DEPTH_TO_DEGREE[depth]
        mine = ref.step_coefficients(0.44, deg).numpy()
        theirs = poly_eval.chebyshev_coefficients(lambda v: 1.0 if v >= 0.44 else -1.0, deg)
        assert np.allclose(mine, theirs, atol=1e-15, rtol=0)
    assert ref.F4_COEFS == tuple(poly_eval.F4_COEFS)
    assert ref.DEPTH_TO_DEGREE == poly_eval.DEPTH_TO_DEGREE


def test_answers_of_a_hand_worked_gallery():
    # gallery rows at cosine 1, 0, -1, 0.6 and a zero row with the query e0
    g = torch.tensor([[3.0, 0.0], [0.0, 2.0], [-1.0, 0.0], [0.6, 0.8], [0.0, 0.0]])
    q = torch.tensor([[5.0, 0.0]], dtype=torch.float64)
    a = ref.Answers(g, q, 0.44, 10)
    s = torch.tensor([1.0, 0.0, -1.0, 0.6, 0.0], dtype=torch.float64)
    want = ref.flags_of(s, 0.44, 10)
    assert torch.allclose(a.index(0), want, atol=1e-15)
    assert a.membership(0) == pytest.approx(float(want.sum()))
    # a match reads about 2, a clear non-match about 0
    assert a.index(0)[0].item() == pytest.approx(2.0, abs=1e-3)
    assert a.index(0)[2].item() == pytest.approx(0.0, abs=1e-3)
    assert a.index(0)[3].item() == pytest.approx(2.0, abs=0.05)


def test_check_gaps_on_hand_made_answers():
    g = torch.eye(4, dtype=torch.float32)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    a = ref.Answers(g, q, 0.44, 10)
    exact = a.index(0).clone()
    off = exact.clone()
    off[2] += 0.25
    total = torch.full((2,), a.membership(0), dtype=torch.float64)
    read = [("index", 0, exact), ("index", 0, off), ("membership", 0, total + 0.125)]
    nums, each = check.gaps(read, a, slots=4)
    assert nums == {"flag_gap": pytest.approx(0.25), "member_gap": pytest.approx(0.125)}
    assert check.failed(each, {"flag_gap": 0.2, "member_gap": 0.2}) == 1
    assert check.failed(each, {"flag_gap": 0.3, "member_gap": 0.1}) == 1
    assert check.failed(each, {"flag_gap": 0.1, "member_gap": 0.1}) == 2
    # an index answer with a ciphertext missing, and a kind never read
    short, _ = check.gaps([("index", 0, exact[:2])], a, slots=2)
    assert short["flag_gap"] == math.inf and math.isnan(short["member_gap"])
