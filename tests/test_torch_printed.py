"""``genfer_tpu_torch.printed``: reading a CLI run's printed values back,
and the is_close comparison the bench and ``chip_smoke.py`` hold two runs
to."""

import math

import pytest

from genfer_tpu_torch.printed import disagreements, read_masses, read_results

RUN = """Z = 3.414e-24
E = 2.5
Normalized: p(0) = 0.25
Normalized: p(1) = 0.75
Unnormalized: p(0) = 8.535e-25
Unnormalized: p(1) = 2.5605e-24
Unnormalized: p(n) <= 1e-30 for all n >= 2
"""


def test_reads_points_and_masses_apart():
    assert read_results(RUN) == {"Z": 3.414e-24, "E": 2.5, "p(0)": 0.25,
                                 "p(1)": 0.75}
    assert read_masses(RUN) == {"p(0)": 8.535e-25, "p(1)": 2.5605e-24}


@pytest.mark.parametrize("factor,scaled,bad", [
    (1 + 1e-12, False, []),
    (1 + 1e-12, True, []),
    # a uniform scale fault: far below is_close's absolute 1e-8, caught
    # only by holding the masses relative to Z
    (2.0, False, ["Z"]),
    (2.0, True, ["p(0)", "p(1)", "Z"]),
    (0.0, True, ["p(0)", "p(1)", "Z"]),
])
def test_masses_and_z_are_held_relatively(factor, scaled, bad):
    want = read_masses(RUN)
    want["Z"] = read_results(RUN)["Z"]
    got = {k: v * factor for k, v in want.items()}
    if not scaled:
        got = {"Z": got["Z"]}
        want = {"Z": want["Z"]}
    found = disagreements(got, want, want["Z"] if scaled else None)
    assert [line.split(" = ")[0] for line in found] == bad


def test_points_at_is_close():
    want = {"E": 25.0, "p(0)": 1e-12, "σ": math.nan}
    assert disagreements({"E": 25 * (1 + 5e-10), "p(0)": 5e-9,
                          "σ": math.nan}, want) == []
    assert disagreements({"E": 25 * (1 + 2e-9), "p(0)": 1e-12,
                          "σ": math.nan}, want) == [
        f"E = {25 * (1 + 2e-9)} against 25.0"]
    assert "printed results differ" in disagreements({"E": 2.5}, want)[0]
