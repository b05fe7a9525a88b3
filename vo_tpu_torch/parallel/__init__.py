from vo_tpu_torch.parallel.mesh import make_mesh, make_mesh_1d, shard_frames
