"""hybvio_tpu_torch: the stereo batched VIO step of ``hybvio_tpu`` in
PyTorch, with its image kernels hand-written in CUDA for the NVIDIA H100.

The JAX package ``hybvio_tpu`` is the reference; this package imports
``torch`` and never ``jax`` (only the numpy-only ``hybvio_tpu.config`` and
``hybvio_tpu.io.synthetic`` / ``hybvio_tpu.eval.ate`` of it). Every module
sits at its reference counterpart's path; every tensor is batch-first, with
a leading lane axis where the reference used ``jax.vmap``.

Layout:
  runtime.py   device and precision policy (f64 filter on CPU, f32 on CUDA,
               no TF32)
  random.py    threefry2x32, bit-exact with jax.random
  geometry/    quaternions, poses, pinhole camera
  ekf/         filter state, predict, updates, augmentation
  odometry/    trail, triangulation, visual update, backend, VIO step
  frontend/    pyramid, LK, GFTT, stereo check, RANSAC, tracker
  ops/         CUDA kernels (csrc/) with their plain PyTorch versions
  parallel/    the batched shared-frame step
  convert.py   state exchange with the reference package
"""

__version__ = "0.1.0"
