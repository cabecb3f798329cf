from v2ce_toolbox_tpu_torch.data.voxelize import (  # noqa: F401
    gen_discretized_event_volume_np,
    gen_discretized_event_volume,
    events_to_voxel_grid_np,
)
from v2ce_toolbox_tpu_torch.data.event_pack_dataset import EventPackDataset  # noqa: F401
