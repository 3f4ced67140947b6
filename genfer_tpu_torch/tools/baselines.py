"""Cross-tool baseline generator (reference: src/bin/generate_baselines.rs).

Emits the naive-Bayes MNIST digit-recognition model simultaneously in SGCL,
PSI, Dice and Prodigy syntax from CSV parameter files, for the exact-
inference tool comparison (benchmarks/neurips2023/exact).
"""

from __future__ import annotations

import argparse
from pathlib import Path

DIGIT_PRIORS = [
    "0.098717", "0.11237", "0.0993", "0.10218", "0.097367",
    "0.09035", "0.098633", "0.10442", "0.097517", "0.09915",
]


def _ratio_of(decimal_str: str) -> tuple[int, int]:
    decimals = decimal_str.split(".")[1] if "." in decimal_str else "0"
    return int(decimals), 10 ** len(decimals)


def _stick_breaking(priors) -> list[tuple[int, int]]:
    """Sequential Bernoulli parameters realizing a categorical prior
    (used for the Prodigy encoding, which has no categorical primitive).
    Returned as unreduced integer pairs over a common power-of-ten scale."""
    ratios = [_ratio_of(p) for p in priors]
    scale = max(d for _, d in ratios)
    numers = [n * (scale // d) for n, d in ratios]
    total = sum(numers)
    out = []
    remaining = total
    for n in numers[:-1]:
        out.append((n, remaining))
        remaining -= n
    return out


def generate_digits(priors, observations, params):
    """Return (sgcl, psi, dice, prodigy) source strings.

    ``priors``: 10 decimal strings; ``observations``: pixel values (0/1);
    ``params``: params[digit][pixel] decimal strings."""
    sgcl, psi, dice, prodigy = [], [], [], []

    psi.append("// flags: --dp")
    psi.append("def main() {")

    sgcl.append("y ~ Categorical(" + ", ".join(priors) + ");")
    psi.append(
        "    y := categorical(["
        + ", ".join("%d/%d" % _ratio_of(p) for p in priors)
        + "]);"
    )
    dice.append("let y = discrete(" + ", ".join(priors) + ") in")

    prodigy.append("nat y;\n")
    sticks = _stick_breaking(priors)
    indent = ""
    for i, (num, den) in enumerate(sticks):
        prodigy.append(f"{indent}tmp := bernoulli({num}/{den});")
        prodigy.append(f"{indent}if(tmp = 1) {{")
        prodigy.append(f"{indent}    y := {i};")
        prodigy.append(f"{indent}}} else {{")
        indent += "    "
    prodigy.append(f"{indent}y := {len(sticks)};")
    for _ in range(len(sticks)):
        indent = indent[:-4]
        prodigy.append(f"{indent}}}")

    # dice needs mixed write/writeln semantics ("else " joins the next
    # "if" on one line, reference generate_baselines.rs:121-124)
    dice_pending = ""
    for i in range(len(priors)):
        sgcl.append(f"if y = {i} {{")
        prodigy.append(f"if(y = {i}) {{")
        psi.append(f"    if(y == {i}) {{")
        if i < len(priors) - 1:
            dice.append(dice_pending + f"if y == int(4, {i}) then")
            dice_pending = ""
        for idx, obs in enumerate(observations):
            p = params[i][idx]
            numer, denom = _ratio_of(p)
            sgcl.append(f"    observe {obs} ~ Bernoulli({p});")
            prodigy.append(f"    tmp := bernoulli({numer}/{denom});")
            prodigy.append(f"    observe(tmp = {obs});")
            psi.append(f"        observe(flip({numer}/{denom}) == {obs});")
            neg = "!" if obs == 0 else ""
            dice.append(dice_pending + f"let _ = observe {neg}(flip {p}) in")
            dice_pending = ""
        sgcl.append("}")
        prodigy.append("} else {skip}")
        psi.append("    }")
        dice.append("y")
        if i < len(priors) - 1:
            dice_pending = "else "
    sgcl.append("return y;")
    prodigy.append("\ntmp := 0;\n\n?Pr[y];")
    psi.append("    return y;")
    psi.append("}")
    return (
        "\n".join(sgcl) + "\n",
        "\n".join(psi) + "\n",
        "\n".join(dice) + "\n",
        "\n".join(prodigy) + "\n",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="genfer-baselines")
    ap.add_argument("data_dir", type=Path,
                    help="directory with digitPriors.csv, "
                    "digitObservations.csv, digitParams.csv")
    ap.add_argument("out_dir", type=Path)
    args = ap.parse_args(argv)
    priors = [
        x.strip()
        for x in (args.data_dir / "digitPriors.csv").read_text().strip().split(",")
    ]
    observations = [
        int(x)
        for x in (args.data_dir / "digitObservations.csv")
        .read_text()
        .strip()
        .split(",")
    ]
    params = [
        [x.strip() for x in line.split(",")]
        for line in (args.data_dir / "digitParams.csv").read_text().strip().splitlines()
    ]
    sgcl, psi, dice, prodigy = generate_digits(priors, observations, params)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / "digitRecognition.sgcl").write_text(sgcl)
    (args.out_dir / "digitRecognition.psi").write_text(psi)
    (args.out_dir / "digitRecognition.dice").write_text(dice)
    (args.out_dir / "digitRecognition.pgcl").write_text(prodigy)
    print(f"wrote 4 baselines to {args.out_dir}")


if __name__ == "__main__":
    main()
