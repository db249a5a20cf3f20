from jacobiforcing_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from jacobiforcing_tpu_torch.parallel.sharding import (  # noqa: F401
    param_specs,
    kv_cache_spec,
    shard_params,
)
