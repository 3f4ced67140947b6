"""Benchmark model-family generators
(reference: src/bin/generate_{hmm,mixture,switchpoint,population_examples,
two_populations,baselines}.rs).

Each generator emits SGCL programs for a model family.  Where the reference
simulated data with a seeded Rust RNG, we simulate with a seeded numpy RNG;
the emitted model structure is identical, the simulated observations can
differ (the committed benchmark corpus carries its own fixed data).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# Coal-mining disasters, years 1851-1961 (public PyMC example dataset;
# also used by the reference generate_mixture/generate_switchpoint)
COAL_MINING_DATA = [
    4, 5, 4, 0, 1, 4, 3, 4, 0, 6, 3, 3, 4, 0, 2, 6, 3, 3, 5, 4, 5, 3, 1, 4,
    4, 1, 5, 5, 3, 4, 2, 5, 2, 2, 3, 4, 2, 1, 3, -1, 2, 1, 1, 1, 1, 3, 0, 0,
    1, 0, 1, 1, 0, 0, 3, 1, 0, 3, 2, 2, 0, 1, 1, 1, 0, 1, 0, 1, 0, 0, 0, 2,
    1, 0, 0, 0, 1, 1, 0, 2, 3, 3, 1, -1, 2, 1, 1, 1, 1, 2, 4, 2, 0, 0, 1, 4,
    0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1,
]


def generate_hmm(out_path, n_steps: int = 30, seed: int = 0) -> str:
    """2-state Poisson HMM (reference: generate_hmm.rs)."""
    rng = np.random.default_rng(seed)
    rate1, rate2 = 0.5, 2.5
    state = 1
    data = []
    for _ in range(n_steps):
        if state == 0:
            data.append(int(rng.poisson(rate1)))
            state = int(rng.random() < 0.2)
        else:
            data.append(int(rng.poisson(rate2)))
            state = int(rng.random() < 0.8)
    lines = [f"# data: {data}", ""]
    lines.append("State := 1;")
    lines.append("Rate1 ~ Geometric(0.1);")
    lines.append("Rate2 ~ Geometric(0.1);")
    for d in data:
        lines.append(
            f"""if State = 0 {{
    observe {d} ~ Poisson(0.1 * Rate1);
    State ~ Bernoulli(0.2);
}} else {{
    observe {d} ~ Poisson(0.1 * Rate2);
    State ~ Bernoulli(0.8);
}}"""
        )
    lines += ["", "return Rate2;"]
    return _emit(out_path, "\n".join(lines) + "\n")


def generate_mixture(out_path) -> str:
    """Coal-mining Poisson mixture (reference: generate_mixture.rs)."""
    lines = ["Rate1 ~ Geometric(0.1);", "Rate2 ~ Geometric(0.1);"]
    for d in COAL_MINING_DATA:
        if d < 0:
            continue
        lines.append(
            f"""if 1 ~ Bernoulli(0.5) {{
    observe {d} ~ Poisson(0.1 * Rate1);
}} else {{
    observe {d} ~ Poisson(0.1 * Rate2);
}}"""
        )
    lines += ["", "return Rate1;"]
    return _emit(out_path, "\n".join(lines) + "\n")


def generate_switchpoint(out_path, continuous: bool = False,
                         data=COAL_MINING_DATA) -> str:
    """Switchpoint model, discrete or continuous rate
    (reference: generate_switchpoint.rs), on ``data`` (negative entries
    are missing counts)."""
    lines = []
    rate_stmt = (
        "rate ~ Exponential(1);" if continuous else "rate ~ Geometric(0.1);"
    )
    lines.append(rate_stmt)
    parts = []
    for switchpoint in range(len(data)):
        parts.append(f"if 1 ~ Bernoulli(1 / {len(data) - switchpoint}) {{")
        for i, d in enumerate(data):
            if switchpoint == i:
                parts.append(rate_stmt)
            if d >= 0:
                if continuous:
                    parts.append(f"observe {d} ~ Poisson(rate);")
                else:
                    parts.append(f"observe {d} ~ Poisson(0.1 * rate);")
        parts.append(f"switchpoint := {switchpoint};")
        parts.append("} else ")
    lines.append("\n".join(parts) + "{}")
    lines += ["", "return switchpoint;"]
    return _emit(out_path, "\n".join(lines) + "\n")


# Winner et al. NeurIPS 2016 population data
ARRIVAL_RATE_FRACTIONS = [0.0257, 0.1163, 0.2104, 0.1504, 0.0428]
SURVIVAL_RATE = 0.2636
DETECTION_PROB = 0.2


def generate_population(out_path, size: int, num_vars: int,
                        modified: bool = False, seed: int = 0) -> str:
    """Poisson-Binomial population model with 1-4 program variables
    (reference: generate_population_examples.rs)."""
    rng = np.random.default_rng(seed)
    arrival_rates = [f * size for f in ARRIVAL_RATE_FRACTIONS]
    populations = [int(rng.poisson(arrival_rates[0]))]
    observations = [0]
    for i in range(1, 5):
        new_arrivals = int(rng.poisson(arrival_rates[i]))
        survivors = int(rng.binomial(populations[i - 1], SURVIVAL_RATE))
        populations.append(new_arrivals + survivors)
        observations.append(int(rng.binomial(populations[i], DETECTION_PROB)))
    lines = [f"population ~ Poisson({arrival_rates[0]});"]
    for i in range(4):
        lines.append("")
        rate = arrival_rates[i + 1]
        if num_vars >= 2:
            if modified:
                lines.append(
                    f"if 1 ~ Bernoulli(0.1) {{ arrivals ~ Poisson({rate / 10.0}); }} "
                    f"else {{ arrivals ~ Poisson({rate}); }}"
                )
            else:
                lines.append(f"arrivals ~ Poisson({rate});")
            if num_vars >= 4:
                lines.append(
                    f"survivors ~ Binomial(population, {SURVIVAL_RATE});\n"
                    "population := survivors;\npopulation += arrivals;"
                )
            else:
                lines.append(
                    f"population ~ Binomial(population, {SURVIVAL_RATE});\n"
                    "population += arrivals;"
                )
        else:
            lines.append(f"population ~ Binomial(population, {SURVIVAL_RATE});")
            if modified:
                lines.append(
                    f"if 1 ~ Bernoulli(0.1) {{ population +~ Poisson({rate / 10.0}); }} "
                    f"else {{ population +~ Poisson({rate}); }}"
                )
            else:
                lines.append(f"population +~ Poisson({rate});")
        if num_vars >= 3:
            lines.append(
                f"observed ~ Binomial(population, {DETECTION_PROB});\n"
                f"observe observed = {observations[i + 1]};"
            )
        else:
            lines.append(
                f"observe {observations[i + 1]} ~ "
                f"Binomial(population, {DETECTION_PROB});"
            )
    lines += ["", "return population"]
    return _emit(out_path, "\n".join(lines) + "\n")


def _two_populations_data(size: int, seed: int = 0):
    """The published constants at ``size`` and the simulated counts of
    ``seed``: (initial rates, each round's arrival rates, migration,
    survival of species 1 and 2, detection, each round's counts)."""
    rng = np.random.default_rng(seed)
    fr = ARRIVAL_RATE_FRACTIONS
    arrival_rates = [(f * 0.9 * size, f * 0.1 * size) for f in fr]
    prob1to2 = 0.1
    survival = SURVIVAL_RATE
    det = DETECTION_PROB
    pops = [(int(rng.poisson(arrival_rates[0][0])), int(rng.poisson(arrival_rates[0][1])))]
    obs = []
    for i in range(1, 5):
        new1 = int(rng.poisson(arrival_rates[i][0]))
        new2 = int(rng.poisson(arrival_rates[i][1]))
        p1, p2 = pops[i - 1]
        p2 += int(rng.binomial(p1, prob1to2))
        s1 = int(rng.binomial(p1, survival * (1 - prob1to2)))
        s2 = int(rng.binomial(p2, survival))
        pops.append((new1 + s1, new2 + s2))
        obs.append(
            (int(rng.binomial(pops[i][0], det)), int(rng.binomial(pops[i][1], det)))
        )
    return (arrival_rates[0], arrival_rates[1:], prob1to2,
            survival * (1 - prob1to2), survival, det, obs)


def _two_populations_text(init, arrivals, mig, s1, s2, det, obs) -> str:
    lines = [
        f"population1 ~ Poisson({init[0]});",
        f"population2 ~ Poisson({init[1]});",
    ]
    for (a1, a2), (c1, c2) in zip(arrivals, obs):
        lines.append("")
        lines.append(
            f"population2 +~ Binomial(population1, {mig});\n"
            f"population1 ~ Binomial(population1, {s1});\n"
            f"population2 ~ Binomial(population2, {s2});"
        )
        lines.append(
            f"population1 +~ Poisson({a1});\n"
            f"population2 +~ Poisson({a2});"
        )
        lines.append(
            f"observe {c1} ~ Binomial(population1, {det});\n"
            f"observe {c2} ~ Binomial(population2, {det});"
        )
    lines += ["", "return population2"]
    return "\n".join(lines) + "\n"


def generate_two_populations(out_path, size: int, seed: int = 0) -> str:
    """Two-species population model (reference: generate_two_populations.rs)."""
    return _emit(out_path,
                 _two_populations_text(*_two_populations_data(size, seed)))


def two_populations_serving(size: int, seed: int = 0) -> tuple[str, dict]:
    """``generate_two_populations``'s program with three parameters in
    place of published probabilities: ``$s1`` for species 1's survival
    times (1 - migration), ``$s2`` for species 2's survival and ``$det``
    for the detection of every observation; every other constant as
    generated.  Returns the source and its constants (the ``model`` of
    the benchmark's reference,
    ``benchmark/reference/two_populations_2000.py``)."""
    init, arrivals, mig, _, _, _, obs = _two_populations_data(size, seed)
    source = _two_populations_text(init, arrivals, mig, "$s1", "$s2",
                                   "$det", obs)
    model = {"init_rates": list(init),
             "arrival_rates": [list(a) for a in arrivals],
             "migration": mig, "observed": [list(c) for c in obs]}
    return source, model


DIGIT_PRIORS = [
    "0.098717", "0.11237", "0.0993", "0.10218", "0.097367",
    "0.09035", "0.098633", "0.10442", "0.097517", "0.09915",
]


def generate_digit_recognition(out_path, params, observations) -> str:
    """Naive-Bayes MNIST digit recognition in SGCL
    (reference: generate_baselines.rs:9-133).

    ``params``: 10 rows of 784 Bernoulli parameters (strings);
    ``observations``: 784 observed pixel values (0/1)."""
    lines = [
        "y ~ Categorical(" + ", ".join(DIGIT_PRIORS) + ");"
    ]
    n_pixels = len(observations)
    for px in range(n_pixels):
        branches = []
        for digit in range(10):
            branches.append(
                f"if y = {digit} {{ observe {observations[px]} ~ "
                f"Bernoulli({params[digit][px]}); }}"
            )
        lines.append(" else ".join(branches))
    lines += ["", "return y"]
    return _emit(out_path, "\n".join(lines) + "\n")


#: the class priors of the reference's digitRecognition benchmark
DIGIT_PRIORS = [
    "0.098717", "0.11237", "0.0993", "0.10218", "0.097367",
    "0.09035", "0.098633", "0.10442", "0.097517", "0.09915",
]


def digit_serving_source(n_pixels: int) -> tuple[str, list[str]]:
    """The naive-Bayes digit model with one evidence parameter a (class,
    pixel): ``observe 1 ~ Bernoulli($e<c>_<i>)``, the image folded into
    the parameters (``e = x theta + (1 - x)(1 - theta)``), and its
    parameter order (examples/digit_serving.py::model_source)."""
    lines = ["y ~ Categorical(" + ", ".join(DIGIT_PRIORS) + ");"]
    params = []
    for c in range(10):
        lines.append(f"if y = {c} {{")
        for i in range(n_pixels):
            name = f"e{c}_{i}"
            params.append(name)
            lines.append(f"    observe 1 ~ Bernoulli(${name});")
        lines.append("}")
    lines.append("return y")
    return "\n".join(lines), params


def population_scan_source(init_lam, lams, cs, delta, rho) -> str:
    """The population block (generate_population_examples.rs) over the
    rounds ``(lams[k], cs[k])``, as ``models.CompiledPopulation`` runs it."""
    lines = [f"population ~ Poisson({float(init_lam)!r});"]
    for lam, c in zip(lams, cs):
        lines += [
            f"arrivals ~ Poisson({float(lam)!r});",
            f"population ~ Binomial(population, {float(delta)!r});",
            "population += arrivals;",
            f"observe {int(c)} ~ Binomial(population, {float(rho)!r});",
        ]
    lines.append("return population")
    return "\n".join(lines)


def two_populations_scan_source(init_lams, lam1s, lam2s, c1s, c2s, d1, d2,
                                mig, rho) -> str:
    """The two-species block (generate_two_populations.rs) over the given
    rounds, as ``models.CompiledTwoPopulations`` runs it."""
    lines = [
        f"population1 ~ Poisson({float(init_lams[0])!r});",
        f"population2 ~ Poisson({float(init_lams[1])!r});",
    ]
    for l1, l2, c1, c2 in zip(lam1s, lam2s, c1s, c2s):
        lines += [
            f"population2 +~ Binomial(population1, {float(mig)!r});",
            f"population1 ~ Binomial(population1, {float(d1)!r});",
            f"population2 ~ Binomial(population2, {float(d2)!r});",
            f"population1 +~ Poisson({float(l1)!r});",
            f"population2 +~ Poisson({float(l2)!r});",
            f"observe {int(c1)} ~ Binomial(population1, {float(rho)!r});",
            f"observe {int(c2)} ~ Binomial(population2, {float(rho)!r});",
        ]
    lines.append("return population2")
    return "\n".join(lines)


def _emit(out_path, text: str) -> str:
    if out_path is not None:
        Path(out_path).write_text(text, encoding="utf-8")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(prog="genfer-generate")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("hmm")
    p.add_argument("out", type=Path)
    p.add_argument("--steps", type=int, default=30)
    p = sub.add_parser("mixture")
    p.add_argument("out", type=Path)
    p = sub.add_parser("switchpoint")
    p.add_argument("out", type=Path)
    p.add_argument("--continuous", action="store_true")
    p = sub.add_parser("population")
    p.add_argument("out", type=Path)
    p.add_argument("--size", type=int, default=50)
    p.add_argument("--num-vars", type=int, default=1)
    p.add_argument("--modified", action="store_true")
    p = sub.add_parser("two-populations")
    p.add_argument("out", type=Path)
    p.add_argument("--size", type=int, default=50)
    args = ap.parse_args(argv)
    if args.cmd == "hmm":
        generate_hmm(args.out, args.steps)
    elif args.cmd == "mixture":
        generate_mixture(args.out)
    elif args.cmd == "switchpoint":
        generate_switchpoint(args.out, args.continuous)
    elif args.cmd == "population":
        generate_population(args.out, args.size, args.num_vars, args.modified)
    elif args.cmd == "two-populations":
        generate_two_populations(args.out, args.size)


if __name__ == "__main__":
    main()
