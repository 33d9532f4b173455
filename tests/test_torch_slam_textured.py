"""The port's SLAM session (on the CPU) on its own against the reference's,
over test_slam.py's revisit (out 1.2 m and back, the tracks broken on the
way back) rendered with render_view (sky background + landmark blobs) at
320x240, with the multi-scale keypoints on (the reference on its JAX
detector, 8 levels): on textured frames the port's own descriptors,
keypoints and vocabulary give the reference's session frame by frame,
nothing taken from the reference. The comparison is
test_torch_slam_session.py's: keyframe ids, map-point ids, observations,
track aliases, loop events and edges exactly, poses and points to POSE_TOL."""
import torch

from test_torch_slam_session import (_loop_setup, _revisit_frames, _run,  # noqa: F401
                                     reference_jax_detector)

torch.set_num_threads(1)


def test_session_textured_revisit_equals_reference_on_its_own():
    port, ref = _run(_revisit_frames(textured=True), lambda p: _loop_setup(p, keypoints=True),
                     dict(max_ba_keyframes=8))
    assert port.loop_events and all(port.keyframes[k].kp_desc is not None
                                    for k in port.kf_order)
    assert ref.keyframes[ref.kf_order[-1]].kp_valid.sum() > 50
