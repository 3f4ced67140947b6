"""The port's copies of genfer_tpu's command-line tools print genfer_tpu's
bytes: ``stats`` and ``translate`` (to WebPPL and to Anglican) on
``examples/*.sgcl`` and on programs of the generator families, and
``baselines`` on small priors, observations and parameters written here
(the reference's CSVs are not in the repo).  Where genfer_tpu's tool
raises (Anglican has no while loop), the port's raises the same error."""

import contextlib
import io
from pathlib import Path

import pytest

import genfer_tpu.tools.baselines as jbaselines
import genfer_tpu.tools.generators as jgen
import genfer_tpu.tools.stats as jstats
import genfer_tpu.tools.translate as jtranslate
from genfer_tpu_torch.tools import baselines, stats, translate

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = {p.name: p.read_text()
            for p in sorted((REPO / "examples").glob("*.sgcl"))}
GENERATED = {
    "hmm(5)": jgen.generate_hmm(None, n_steps=5),
    "mixture": jgen.generate_mixture(None),
    "switchpoint": jgen.generate_switchpoint(None),
    "switchpoint(continuous)": jgen.generate_switchpoint(None,
                                                         continuous=True),
    "population(50, 4)": jgen.generate_population(None, 50, 4),
    "two_populations(50)": jgen.generate_two_populations(None, 50),
}
PROGRAMS = {**EXAMPLES, **GENERATED}


def _run(main, argv):
    """What ``main(argv)`` printed, and the error it raised (type and
    message) or None."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    except Exception as e:  # compared between the packages
        return buf.getvalue(), (type(e), str(e))
    return buf.getvalue(), None


def _program(tmp_path, name: str) -> Path:
    path = tmp_path / "model.sgcl"
    path.write_text(PROGRAMS[name])
    return path


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_stats_prints_genfer_tpus_bytes(name, tmp_path):
    path = _program(tmp_path, name)
    got = _run(stats.main, [str(path)])
    assert got == _run(jstats.main, [str(path)])
    assert "statements (including nesting)" in got[0]


@pytest.mark.parametrize("target", ["webppl", "anglican"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_translate_prints_genfer_tpus_bytes(name, target, tmp_path):
    path = _program(tmp_path, name)
    got = _run(translate.main, [target, str(path)])
    assert got == _run(jtranslate.main, [target, str(path)])
    if got[1] is None:
        assert got[0].strip()
    else:  # the only refusal: a while loop in Anglican
        assert (target, got[1][0]) == ("anglican", NotImplementedError)


PRIORS = ["0.098717", "0.11237", "0.0993", "0.10218", "0.097367",
          "0.09035", "0.098633", "0.10442", "0.097517", "0.09915"]
CASES = {
    "three pixels": ([1, 0, 1], 3),
    "one pixel": ([0], 1),
    "eight pixels": ([1, 1, 0, 0, 1, 0, 1, 1], 8),
}


def _params(pixels: int):
    """params[digit][pixel]: decimal strings of several lengths."""
    return [[f"0.{(37 * d + 11 * p) % 97 + 1:02d}{'5' * (p % 3)}"
             for p in range(pixels)] for d in range(10)]


@pytest.mark.parametrize("case", list(CASES))
def test_baselines_generate_genfer_tpus_sources(case):
    observations, pixels = CASES[case]
    params = _params(pixels)
    got = baselines.generate_digits(PRIORS, observations, params)
    assert got == jbaselines.generate_digits(PRIORS, observations, params)
    assert got[0].startswith("y ~ Categorical(0.098717, ")


def test_baselines_main_writes_genfer_tpus_files(tmp_path):
    """``main DATA OUT`` reads the three CSVs and writes the four sources:
    the same files and the same line (but for the directory named) in both
    packages."""
    observations, pixels = CASES["three pixels"]
    data = tmp_path / "data"
    data.mkdir()
    (data / "digitPriors.csv").write_text(", ".join(PRIORS) + "\n")
    (data / "digitObservations.csv").write_text(
        ",".join(map(str, observations)) + "\n")
    (data / "digitParams.csv").write_text(
        "\n".join(", ".join(row) for row in _params(pixels)) + "\n")
    printed = {}
    for label, main in (("port", baselines.main), ("ref", jbaselines.main)):
        out, err = _run(main, [str(data), str(tmp_path / label)])
        assert err is None
        printed[label] = out.replace(str(tmp_path / label), "OUT")
    assert printed["port"] == printed["ref"] == "wrote 4 baselines to OUT\n"
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 4
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
