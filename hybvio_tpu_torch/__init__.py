"""hybvio_tpu_torch: the stereo batched VIO step of ``hybvio_tpu`` in
PyTorch, with its image kernels hand-written in CUDA for the NVIDIA H100.

The JAX package ``hybvio_tpu`` is the reference; this package imports
``torch`` and never ``jax`` nor anything of ``hybvio_tpu``: it keeps its own
copies of the parameter surface (``config/``), the synthetic world
(``io/synthetic.py``) and the ATE (``eval/ate.py``). Every module sits at its
reference counterpart's path; every tensor is batch-first, with a leading
lane axis where the reference used ``jax.vmap``. The entry points run on the
card unless the caller passes ``device="cpu"``.

Layout:
  runtime.py   device and precision policy (f64 filter on CPU, f32 on CUDA,
               no TF32)
  config/      Parameters, parameter_names, DerivedParameters
  io/          recorded input (JSONL, EuRoC ASL, legacy CSV; frames through
               the native PNG / PGM decoder, native/, or PIL) and the
               synthetic world of the smoke run and the tests
  eval/        ATE
  random.py    threefry2x32, bit-exact with jax.random
  geometry/    quaternions, poses, the pinhole (radial distortion,
               rectification rotation) and KB4 fisheye cameras
  ekf/         filter state, predict, updates, augmentation
  odometry/    trail, triangulation, visual update, backend, VIO step
  frontend/    pyramid, LK, GFTT, FAST, stereo check, rectification, SAD
               disparity, RANSAC, tracker
  slam/        the SLAM session: keyframes, ORB, vocabulary, BA, pose graph,
               loop closure (coupled to the VIO by odometry/slam_coupling.py)
  ops/         CUDA kernels (csrc/) with their plain PyTorch versions
  parallel/    the batched step, over one device or a mesh, and the scan
  graphs.py    the compiled step: CUDA graphs of a step, the card's jax.jit
  tools/       the repository's tools: datasets, the multi-sequence runner,
               the long probe, the stage profiler, the SLAM cost curve, the
               BA sweep (each ``python -m hybvio_tpu_torch.tools.<name>``)
  convert.py   state exchange with the reference package
"""

__version__ = "0.1.0"
