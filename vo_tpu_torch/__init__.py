"""vo_tpu_torch: the PyTorch + CUDA port of vo_tpu, the visual-odometry / SfM engine.

Every module of the JAX package ``vo_tpu`` has its counterpart here, with the same
layout and names: the front-ends (ORB-like, SIFT config, SURF, oriented BRIEF, true
stereo, R2D2), the RGB-D and monocular engines, refinement (bundle adjustment, pose
graph, loop closure), R2D2 training, the distributed layer, I/O, the CLIs and the port
of ``bench.py`` (``runners/bench.py``; the port's benchmark is ``benchmark/``). The
kernels are hand-written CUDA for Hopper (``ops/csrc``, built by ``ops/kernels.py``).
``vo_tpu`` is the reference; this package imports nothing of it.
"""

__version__ = "0.1.0"
