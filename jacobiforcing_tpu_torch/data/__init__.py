from jacobiforcing_tpu_torch.data.pack import pack_trajectories  # noqa: F401
from jacobiforcing_tpu_torch.data.collect import (  # noqa: F401
    collect_trajectories,
    synthesize_trajectories_masking,
)
