"""Library API for programmatic inference: the twin of genfer_tpu's
``api.py``.

    from genfer_tpu_torch import api
    result = api.infer("X ~ Poisson(10); observe 1 ~ Binomial(X, 0.2); return X")
    result.total, result.mean, result.probs(10)

``infer`` and ``infer_file`` use only the framework-free layers and the
CLI's ``select_mode``; ``compile_serving`` is the scan compiler
(``scanc.py``) as a library call, on the card by default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .gf.extract import (
    central_to_standardized_moments,
    moments_taylor,
    moments_to_central_moments,
    probs_taylor,
)
from .lang.parser import parse_program
from .semantics.gf_transformer import GfTransformer


@dataclass
class InferenceResult:
    """Posterior summary for the program's result variable.

    Scalars are host numbers from :mod:`genfer_tpu_torch.numbers` (call
    ``.to_float()`` / ``.display()`` as needed)."""

    program: object
    translation: object
    backend: object
    total: object  # Z (unnormalized total mass)
    raw_moments: list  # orders 1..4, normalized by Z
    var_info: object

    @property
    def mean(self):
        return self.raw_moments[0]

    @property
    def variance(self):
        _, central = moments_to_central_moments(self.raw_moments)
        return central[0]

    def standardized(self):
        """(variance, skewness, kurtosis)."""
        _, central = moments_to_central_moments(self.raw_moments)
        variance, std = central_to_standardized_moments(central)
        return variance, std[0], std[1]

    def probs(self, n: int, normalized: bool = True) -> list:
        """Posterior masses p(0..n-1) of the result variable."""
        ps = probs_taylor(
            self.translation.gf,
            self.backend,
            self.program.result,
            self.var_info,
            n,
        )
        if normalized:
            return [p / self.total for p in ps]
        return ps


def infer(
    source: str,
    *,
    mode: str = "f64",
    backend: Optional[str] = None,
    unroll: int = 8,
    simplify: bool = True,
    precision: Optional[int] = None,
    device=None,
) -> InferenceResult:
    """Run exact inference on an SGCL program.

    mode: "f64" | "rational" | "bigfloat" | "multiprec" | any of those
    with "-bounds" appended for interval arithmetic (e.g. "f64-bounds").
    backend: None (auto) | "jax" | "numpy" | "hybrid" | "pallas" |
    "object", as the CLI's ``--backend``.  ``device``: the torch device of
    the device backends (None: the CUDA card, which they then need).
    """
    import argparse

    from .cli import select_mode

    bounds = mode.endswith("-bounds")
    base = mode.removesuffix("-bounds")
    args = argparse.Namespace(
        rational=base == "rational",
        precision=precision if base == "multiprec" else None,
        big_float=base == "bigfloat",
        bounds=bounds,
        backend=backend,
    )
    if base == "multiprec" and precision is None:
        args.precision = 100
    T, backend_obj, _elem = select_mode(args, device=device)
    program = parse_program(source)
    translation = GfTransformer(T, unroll=unroll).semantics(program)
    if simplify:
        translation.gf = translation.gf.simplify(backend_obj)
        translation.rest = translation.rest.simplify(backend_obj)
    total, moments = moments_taylor(
        translation.gf, backend_obj, program.result, translation.var_info, 5
    )
    return InferenceResult(
        program=program,
        translation=translation,
        backend=backend_obj,
        total=total,
        raw_moments=moments,
        var_info=translation.var_info,
    )


def infer_file(path, **kwargs) -> InferenceResult:
    with open(path, "r", encoding="utf-8") as f:
        return infer(f.read(), **kwargs)


def compile_serving(source: str, *, order: int = 128,
                    params: Optional[dict] = None,
                    max_steps: Optional[int] = None,
                    device=None):
    """Compile an SGCL program to its scan form for repeated serving (the
    CLI's ``--compile-scan`` as a library call).

    Returns the compiled object, truncation-validated by grid doubling:
    ``run()`` reproduces the committed dataset, ``run_with_data`` /
    ``run_batch`` serve fresh observation datasets (one vmapped call, a
    replayed CUDA graph on the card, for a whole batch),
    ``run_param_sweep`` sweeps ``$param`` bindings without recompiling,
    and telescoping cascades expose ``run_with_counts`` (host numpy, as
    in genfer_tpu).  Raises ``scanc.UnsupportedForScan`` when the program
    is outside the compiler's fragment (use :func:`infer`).

    ``device``: ``None`` (default) is the CUDA card, which must exist;
    ``"cpu"`` runs on the host.  genfer_tpu defaults to the CPU here; the
    port's entry points run on the card unless asked otherwise."""
    from .scanc import compile_scan_program

    program = parse_program(source)
    obj, _ = compile_scan_program(
        program, order=order, params=params, max_steps=max_steps,
        device=device,
    )
    return obj
