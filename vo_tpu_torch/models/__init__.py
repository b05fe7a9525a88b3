from vo_tpu_torch.models.patchnet import (
    PatchNetSpec,
    FAST_QUAD_L2NET_CONFCFS,
    QUAD_L2NET_CONFCFS,
    init_patchnet_params,
    apply_patchnet,
)
