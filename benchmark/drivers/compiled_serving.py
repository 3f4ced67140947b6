"""The entry kind ``compiled_serving``: a parameterized SGCL program
translated once by ``genfer_tpu_torch.compile.CompiledProgram`` and
served by ``probs_batch`` (the vmapped walk, captured once per batch
shape as a CUDA graph and replayed; the output cloned).  The
configuration gives the program's source, its parameters and its limit.
"""

from __future__ import annotations


class Driver:
    """The program under test; calling it serves one batch of parameter
    rows and returns the unnormalized masses p(0..limit-1) a row, on the
    device."""

    def __init__(self, config: dict, device):
        from genfer_tpu_torch.compile import CompiledProgram

        self.program = CompiledProgram(config["program"], config["params"],
                                       config["limit"], device=device)

    def __call__(self, params):
        return self.program.probs_batch(params)
