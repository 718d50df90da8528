"""Multi-process runs of the port: data parallelism over torch.distributed
(`parallel.mesh`)."""

from rnnt_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_gather_ints, all_reduce_sum, all_reduce_sum_, barrier,
    broadcast_module_, data_read_group, init_distributed, make_mesh,
    read_group_process_count)
