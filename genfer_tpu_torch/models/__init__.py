"""Model-family pipelines, the twins of genfer_tpu's ``models``.

Where ``genfer_tpu_torch.compile`` walks the generic GF DAG, these modules
exploit model structure: a repeated observation block is one step of a
loop over ``max_steps`` (genfer_tpu's ``lax.scan`` body), so the work a
step does is independent of the number of observations.  On the card each
entry point is a CUDA graph (``compile.GraphedEntry``, genfer_tpu's
``jit``), captured once per argument shape; on the CPU it runs eagerly.
"""

from .hmm import CompiledHMM, CompiledMixture
from .population import CompiledPopulation, CompiledTwoPopulations

__all__ = ["CompiledHMM", "CompiledMixture", "CompiledPopulation",
           "CompiledTwoPopulations"]
