"""Tensor parallelism of the port (counterpart of
`llm_inference_tpu/parallel/`): one process per rank over
torch.distributed (`mesh`), and the slicing of parameters and caches for
one rank (`sharding`)."""

from llm_inference_tpu_torch.parallel.mesh import (TPGroup, backend_for,
                                                   run_ranks)
from llm_inference_tpu_torch.parallel.sharding import (local_kv_heads,
                                                       shard_params,
                                                       validate_tp)

__all__ = ["TPGroup", "backend_for", "run_ranks", "local_kv_heads",
           "shard_params", "validate_tp"]
