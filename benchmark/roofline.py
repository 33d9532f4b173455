"""The least time an H100 could take for each of the port's kernels at an
input shape, from the bytes it must move and the float32 operations it
must do (a copy of ``chip_smoke.py``'s arithmetic), and the share of that
least time in the kernels' measured device time.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s in
float32 outside the tensor cores, at the 700 W power limit. Each input
byte is counted once and each output byte once. Shapes are the keys under
which ``hybvio_tpu_torch.ops`` counts launches (``SHAPE_LAUNCHES``).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _levels(H, W, L):
    hw = [(H, W)]
    for _ in range(L):
        hw.append(((hw[-1][0] + 1) // 2, (hw[-1][1] + 1) // 2))
    return hw


def _blur_ops(hw):
    """A separable 5-tap blur computed at the decimated points: 9 operations
    a point of each pass."""
    return sum(9 * hw[l - 1][0] * w + 9 * h * w for l, (h, w) in enumerate(hw) if l > 0)


def cost(kernel: str, shape: tuple) -> tuple:
    """(bytes, float32 operations) of one launch of ``kernel`` at ``shape``."""
    if kernel in ("pyramid_scharr", "pyr_down"):
        n, lanes, H, W, L = shape
        hw = _levels(H, W, L)
        out = n * sum(h * w for h, w in hw[1:])
        nbytes, ops = n * H * W + out, n * _blur_ops(hw)
        if kernel == "pyramid_scharr":
            # the (Ix, Iy) of levels 0..L of the first image: 2 x 10
            # operations a pixel
            nbytes += 2 * sum(h * w for h, w in hw)
            ops += sum(20 * h * w for h, w in hw)
        return 4 * lanes * nbytes, lanes * ops
    if kernel == "scharr":
        lanes, H, W = shape
        return 4 * lanes * 3 * H * W, lanes * 20 * H * W
    if kernel == "corner_response":
        lanes, H, W, bs = shape
        return 4 * lanes * 2 * H * W, lanes * (46 + 6 * (bs - 3)) * H * W
    if kernel == "greedy_nms":
        B, K, mode = shape
        return 4 * K * K * (B if mode == "per-lane" else 1) + 2 * B * K, B * K * (K - 1) // 2
    if kernel == "patch_gather":
        # the windows written and their origins read; the image pixels the
        # windows cover depend on where they lie and are left out, so this
        # is a lower bound
        k, B, N, ps = shape[:4]
        return 4 * (k * B * N * ps * ps + 2 * B * N), 0
    raise KeyError(f"no cost for kernel {kernel!r}")


def bound_s(kernel: str, shape: tuple) -> float:
    nbytes, ops = cost(kernel, shape)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def family(kernel: str) -> str:
    """The __global__ function a launch counter's kernel runs
    (``trace.KERNEL_FUNCTIONS``' keys)."""
    return "pyramid" if kernel in ("pyramid_scharr", "pyr_down") else kernel


def share_pct(launches: dict, kernel_s: dict):
    """100 x the summed least time of ``launches`` ((kernel, shape) ->
    count) over the kernels' summed device time (family -> s) in the same
    window; None where either is empty."""
    least = sum(n * bound_s(k, shape) for (k, shape), n in launches.items())
    spent = sum(kernel_s.get(f, 0.0) for f in {family(k) for k, _ in launches})
    if not launches or least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
