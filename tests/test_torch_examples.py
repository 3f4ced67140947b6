"""The serving examples' twins (``examples/digit_serving_torch.py``,
``examples/switchpoint_serving_torch.py``) on the CPU against the JAX
examples' own functions, at the reference's is_close (rel 1e-9 / abs
1e-8).  The reference corpus is not in the repo: the digit models read a
``digitParams.csv`` written from a seed (10 x 784 values, uniform on
[0.05, 0.95] from ``RandomState(0)``), and the switchpoint examples
serve the coal-mining cascade of ``tools/generators.py``.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
REL, ABS = 1e-9, 1e-8


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def theta_dir(tmp_path):
    theta = np.random.RandomState(0).uniform(0.05, 0.95, (10, 784))
    np.savetxt(tmp_path / "digitParams.csv", theta, delimiter=",")
    return tmp_path


def test_digit_twin_matches_the_jax_example(theta_dir):
    from genfer_tpu.compile import _translate_big_stack

    jax_example, twin = _load("digit_serving"), _load("digit_serving_torch")
    jax_example.DATA = twin.DATA = theta_dir
    argv = ["--pixels", "20", "--batch", "8"]
    err = io.StringIO()
    # genfer_tpu's trace of 200 observations recurses past the limit a
    # pytest process leaves: it runs on genfer_tpu's big-stack thread
    with contextlib.redirect_stderr(err):
        want = np.asarray(_translate_big_stack(
            lambda: jax_example.main(argv)))
    lines = err.getvalue()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = twin.main(argv, device="cpu")
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got, want, rtol=REL, atol=ABS)
    # the same lines, but for the times
    def steady(text):
        return [re.sub(r"[\d.]+s", "", line) for line in text.splitlines()
                if "posterior" in line or "predicted" in line]
    assert steady(err.getvalue()) == steady(lines)
    # the evidence vector is a torch tensor on the run's device
    ev = twin.evidence_params(np.zeros((2, 20)), twin.load_theta(20),
                              device="cpu")
    assert ev.shape == (2, 200) and str(ev.device) == "cpu"


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_switchpoint_twin_matches_the_jax_example(tmp_path, monkeypatch):
    from genfer_tpu_torch.tools.generators import generate_switchpoint

    path = tmp_path / "switchpoint.sgcl"
    generate_switchpoint(path, continuous=True)
    argv = ["--file", str(path), "--datasets", "3"]
    jax_example = _load("switchpoint_serving")
    monkeypatch.setattr(sys, "argv", ["switchpoint_serving.py", *argv])
    want = _printed(lambda _: jax_example.main(), argv)
    twin = _load("switchpoint_serving_torch")
    got = _printed(lambda a: twin.main(a, device="cpu"), argv)

    def fields(text):
        z = re.search(r"Z = (\S+), argmax switchpoint = (\d+)", text)
        span = re.search(r"modes span \[(\d+), (\d+)\]", text)
        units = re.search(r"\((\d+) observation units\)", text)
        return float(z[1]), int(z[2]), span.groups(), units[1]

    (z, arg, span, units), (z0, arg0, span0, units0) = (fields(got),
                                                        fields(want))
    assert abs(z - z0) <= ABS + REL * abs(z0)
    assert (arg, span, units) == (arg0, span0, units0)
