from vo_tpu_torch.io.dataset import RGBDSequence, load_rgbd_pair
from vo_tpu_torch.io.poses import (
    save_poses_npy,
    load_poses_npy,
    poses_npy_to_kitti_txt,
    kitti_gt_to_modified_txt,
    write_kitti_txt,
)
