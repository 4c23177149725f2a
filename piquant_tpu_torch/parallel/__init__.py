"""piquant_tpu_torch.parallel — meshes and quantized collectives
(counterpart of piquant_tpu.parallel; ring attention and the pipeline are
ROADMAP.md queue 1 item 16b)."""

from piquant_tpu_torch.parallel.collectives import (  # noqa: F401
    quantized_all_gather,
    quantized_all_reduce,
    quantized_psum,
    quantized_reduce_scatter,
)
from piquant_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    StackedAxis,
    make_mesh,
)
from piquant_tpu_torch.parallel.rdma_ring import (  # noqa: F401
    rdma_all_reduce_shard,
    rdma_quantized_all_reduce,
    rdma_ring_selftest,
)
