"""Benchmark model-family generators: genfer_tpu's own, which import only
numpy, so that a program made for the port reads the same as one made for
genfer_tpu.

    python -m genfer_tpu_torch.tools.generators two-populations tp.sgcl --size 500
"""

from genfer_tpu.tools.generators import (
    generate_digit_recognition,
    generate_hmm,
    generate_mixture,
    generate_population,
    generate_switchpoint,
    generate_two_populations,
    main,
)

__all__ = [
    "generate_digit_recognition",
    "generate_hmm",
    "generate_mixture",
    "generate_population",
    "generate_switchpoint",
    "generate_two_populations",
    "main",
]

if __name__ == "__main__":
    main()
