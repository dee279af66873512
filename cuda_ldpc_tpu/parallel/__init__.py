from cuda_ldpc_tpu.parallel.mesh import (batch_sharding, get_mesh,
                                         host_local_batch)

__all__ = ["get_mesh", "batch_sharding", "host_local_batch"]
