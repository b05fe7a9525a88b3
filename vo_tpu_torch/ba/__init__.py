from vo_tpu_torch.ba.bundle_adjust import BAConfig, BAProblem, bundle_adjust
from vo_tpu_torch.ba.pose_graph import PoseGraphConfig, optimize_pose_graph
