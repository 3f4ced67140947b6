"""Command-line entry point of the port: ``python -m genfer_tpu_torch``.

Twin of ``genfer_tpu.cli``.  The argument parser, the GF translation, the
moment / probability extraction and the printing pipeline are
genfer_tpu's own (none of them imports jax); what differs is the backend
selection, which builds the port's torch backends.  ``--backend jax`` and
``sharded``, ``--compile-scan``, ``--profile`` and ``--debug-nans`` reach
code not yet ported and raise.
"""

from __future__ import annotations

import os
import sys
import time

from genfer_tpu.cli import (
    _offload_scale_flops,
    build_arg_parser,
    print_moments_and_probs_interval,
    translate_program_to_gf,
)
from genfer_tpu.gf.extract import moments_taylor, probs_taylor
from genfer_tpu.lang.parser import parse_program
from genfer_tpu.numbers.scalar import (
    F64,
    BigFloat,
    Interval,
    MultiPrec,
    Rational,
    set_precision,
)

__all__ = ["build_arg_parser", "main", "run", "select_mode"]

_NOT_PORTED = ("jax", "sharded")


def _accelerator_present() -> bool:
    import torch

    return torch.cuda.is_available()


def select_mode(args, program=None, device=None):
    """Choose (host scalar type, array backend, element type) as
    genfer_tpu's ``select_mode`` does.  ``device`` is the torch device of
    the offload backends (``None``: the CUDA card, which must exist)."""
    from genfer_tpu.taylor.backend import (
        NumpyF64Backend,
        NumpyIntervalBackend,
        ObjectBackend,
    )

    from .taylor.backend import HybridBackend, PallasBackend

    if args.rational:
        elem = Rational
    elif args.precision is not None:
        set_precision(args.precision)
        elem = MultiPrec
    elif args.big_float:
        elem = BigFloat
    else:
        elem = F64

    choice = args.backend or os.environ.get("GENFER_BACKEND")
    if choice in _NOT_PORTED:
        raise NotImplementedError(
            f"--backend {choice} is not yet ported to genfer_tpu_torch"
        )
    if choice is None:
        if (
            elem is F64
            and _offload_scale_flops(program, args)
            >= HybridBackend.CONV_OFFLOAD_FLOPS
            and _accelerator_present()
        ):
            # genfer_tpu shards over several devices here; the sharded
            # backend is not ported, so every card count gets the hybrid
            choice = "hybrid"
        else:
            choice = "numpy"
    if args.bounds:
        T = Interval.over(elem)
        if elem is F64 and choice in ("numpy", "hybrid"):
            backend = NumpyIntervalBackend()
        else:
            backend = ObjectBackend(T)
        return T, backend, elem
    T = elem
    if elem is F64 and choice == "hybrid":
        backend = HybridBackend(device)
    elif elem is F64 and choice == "pallas":
        backend = PallasBackend(device)
    elif elem is F64 and choice == "numpy":
        backend = NumpyF64Backend()
    else:
        backend = ObjectBackend(T)
    return T, backend, elem


def main(argv=None):
    """Run everything on a dedicated thread with a large stack: recursion
    depth on deep GF DAGs exceeds default stacks."""
    import threading

    result: list = []

    def work():
        try:
            _main_impl(argv)
        except BaseException as e:  # propagate to the caller's thread
            result.append(e)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(1_000_000)
    # exact-mode results can have numerators with millions of digits
    sys.set_int_max_str_digits(0)
    try:
        threading.stack_size(512 * 1024 * 1024)
        t = threading.Thread(target=work)
        t.start()
        t.join()
    finally:
        threading.stack_size(0)
        sys.setrecursionlimit(old_limit)
    if result:
        raise result[0]


def _main_impl(argv=None):
    args = build_arg_parser().parse_args(argv)
    text = args.file_name.read_text(encoding="utf-8")
    program = parse_program(text)
    if args.print_program:
        print(f"Parsed program:\n{program}\n")
    run(program, args)


def run(program, args, device=None):
    """Inference and printing for one parsed program; ``device`` as in
    ``select_mode``."""
    for on, flag in (
        (args.compile_scan, "--compile-scan"),
        (args.profile is not None, "--profile"),
        (args.debug_nans, "--debug-nans"),
    ):
        if on:
            raise NotImplementedError(
                f"{flag} is not yet ported to genfer_tpu_torch"
            )
    return _run_impl(program, args, device)


def _run_impl(program, args, device=None):
    T, backend, elem = select_mode(args, program, device)
    IV = Interval.over(elem) if not args.bounds else T
    inference_start = time.perf_counter()
    uses_observe = program.uses_observe()
    translation = translate_program_to_gf(T, backend, program, args)
    gf_translation_time = time.perf_counter() - inference_start
    var_info = translation.var_info
    num_vars = var_info.num_vars()

    if args.symbolic:
        from genfer_tpu.gf.symbolic import (
            moments_symbolic,
            probs_symbolic,
            to_computation,
        )

        sym_gf = to_computation(translation.gf, T)
        sym_rest = to_computation(translation.rest, T)
        rest_fn = lambda: sym_rest.evaluate_closed()
        moments_fn = lambda limit: moments_symbolic(
            sym_gf, program.result, var_info, limit
        )
        probs_fn = lambda limit: probs_symbolic(
            sym_gf, program.result, var_info, limit
        )
    else:
        rest_fn = lambda: translation.rest.eval(
            backend, [T.zero()] * num_vars, 1
        ).constant_term_host()
        moments_fn = lambda limit: moments_taylor(
            translation.gf, backend, program.result, var_info, limit
        )
        probs_fn = lambda limit: probs_taylor(
            translation.gf, backend, program.result, var_info, limit
        )

    if args.bounds:
        wrap = lambda x: x
        wrap_moments = lambda tm: tm
        wrap_list = lambda xs: xs
    else:
        wrap = IV.precisely
        wrap_moments = lambda tm: (IV.precisely(tm[0]),
                                   [IV.precisely(m) for m in tm[1]])
        wrap_list = lambda xs: [IV.precisely(x) for x in xs]

    print_moments_and_probs_interval(
        IV,
        lambda: wrap(rest_fn()),
        lambda limit: wrap_moments(moments_fn(limit)),
        lambda limit: wrap_list(probs_fn(limit)),
        var_info[program.result],
        translation.rest_info[program.result],
        uses_observe,
        args,
        inference_start,
        gf_translation_time,
    )
    return backend


if __name__ == "__main__":
    main()
