from jafpro_tpu_torch.data.texture import (  # noqa: F401
    atlas_to_parts,
    parts_to_atlas,
    texture_warp,
    unwrap_texture,
    iuv_to_part_masks,
)
from jafpro_tpu_torch.data.angles import (  # noqa: F401
    compute_angle, select_reference_frames)
