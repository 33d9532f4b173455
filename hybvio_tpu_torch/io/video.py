"""Frame sources: video files and frame directories (port of the reference
package's ``io/video.py``).

The reference decodes video with OpenCV or an ffmpeg subprocess on reader
threads (reference: src/commandline/video_input.cpp). Here a FrameSource
abstraction covers:
  * ``NpyFrameSource``: frame_xxxxxx_camN.npy files (the recorder format),
  * ``ImageDirSource``: PNG/PGM/JPG directories, through the native decoder
    (``io/native_image.py``) first and PIL (imported lazily) after it,
  * ``VideoFileSource``: .mp4/.mov/.avi decoded sequentially by cv2
    (imported when a video is opened; without it the reference's
    ``RuntimeError``).
Sources yield grayscale (H, W) frames: uint8 raw 0-255 where the input is
8-bit (PNG/PGM/JPG image dirs: the frame ships to the device raw and the
step normalizes, 1/4 the H2D bytes), float32 in [0, 1] elsewhere (recorded
.npy frames, and video frames through the reference's luma weights).
Background prefetching mirrors the reference's BoundedInputQueue double
buffering.
"""
from __future__ import annotations

import os
import threading

import numpy as np


class FrameSource:
    def frame(self, number: int, camera_ind: int = 0) -> np.ndarray:
        raise NotImplementedError

    @property
    def shape(self):
        raise NotImplementedError


class NpyFrameSource(FrameSource):
    def __init__(self, directory: str):
        self.dir = directory
        f0 = os.path.join(directory, "frame_000000_cam0.npy")
        if not os.path.exists(f0):
            raise FileNotFoundError(f0)
        self._shape = np.load(f0).shape

    def frame(self, number: int, camera_ind: int = 0) -> np.ndarray:
        return np.load(os.path.join(self.dir, f"frame_{number:06d}_cam{camera_ind}.npy"))

    @property
    def shape(self):
        return self._shape


def load_image_file(path: str) -> np.ndarray:
    """Load one image file as grayscale uint8 (raw 0-255).

    8-bit frames stay 8-bit end to end: VioApi ships them raw and the step
    normalizes on the card (odometry/vio.py normalize_input), so the
    host-to-device copy is 1/4 the bytes of pre-normalized float32
    (reference pipeline likewise carries 8-bit frames, image.cpp:345-367).

    PNG/PGM go through the native decoder (io/native_image.py) first; it
    runs outside the GIL, so prefetch threads overlap decode with the step.
    Anything else, or a file it does not read (e.g. an interlaced PNG),
    goes through PIL. With neither decoder there it raises, naming both."""
    if path.lower().endswith((".png", ".pgm")):
        from .native_image import decode_gray_u8_native, unavailable_reason

        img = decode_gray_u8_native(path)
        if img is not None:
            return img
        native = unavailable_reason() or "it does not read this file"
    else:
        native = "it reads PNG and PGM only"
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"cannot decode {path}: the native decoder (io/native_image.py): "
                           f"{native}; PIL: {e}") from e
    return np.asarray(Image.open(path).convert("L"))


class ImageDirSource(FrameSource):
    """Sorted image files (e.g. EuRoC cam0/data/*.png) as a frame source."""

    def __init__(self, directory: str, pattern_exts=(".png", ".jpg", ".jpeg", ".pgm")):
        self.files = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.lower().endswith(pattern_exts))
        if not self.files:
            raise FileNotFoundError(f"no images in {directory}")
        self._shape = self.frame(0).shape

    def frame(self, number: int, camera_ind: int = 0) -> np.ndarray:
        # uint8 end-to-end: native GIL-free decode first (see load_image_file)
        return load_image_file(self.files[number])

    @property
    def shape(self):
        return self._shape


class VideoFileSource(FrameSource):
    """Sequential video decoding via cv2; frames are read forward only, the
    last one decoded kept (the CLI asks for each frame once, in order)."""

    def __init__(self, path: str):
        self.path = path
        try:
            import cv2
        except ImportError:
            raise RuntimeError(
                "video decoding requires cv2 or ffmpeg (not available in this "
                "environment); convert to an image directory or .npy frames") from None
        self._cap = cv2.VideoCapture(path)
        ok, f0 = self._cap.read()
        if not ok:
            raise RuntimeError(f"cannot read {path}")
        self._cache = {0: self._gray(f0)}
        self._next = 1
        self._shape = self._cache[0].shape

    @staticmethod
    def _gray(frame):
        # reference luma weights (image.cpp:345-367), on cv2's BGR order
        f = frame.astype(np.float32) / 255.0
        if f.ndim == 3:
            return 0.299 * f[..., 2] + 0.587 * f[..., 1] + 0.114 * f[..., 0]
        return f

    def frame(self, number: int, camera_ind: int = 0) -> np.ndarray:
        while self._next <= number:
            ok, f = self._cap.read()
            if not ok:
                raise IndexError(number)
            self._cache = {self._next: self._gray(f)}
            self._next += 1
        return self._cache[number]

    @property
    def shape(self):
        return self._shape


class PrefetchingSource(FrameSource):
    """Background-thread prefetch wrapper (reference: video reader threads +
    BoundedInputQueue, video_input.cpp:23-58). frame(n, cam) queues reads
    for n..n+lookahead of the same camera so the worker decodes ahead of the
    consumer, each frame once (the reference package's copy can queue a
    frame again while the worker decodes it, which a video source cannot
    serve); a worker-side exception is captured and re-raised in the
    consumer (a silently dead worker would hang the pipeline forever)."""

    def __init__(self, inner: FrameSource, lookahead: int = 4):
        self.inner = inner
        self.lookahead = lookahead
        self.results = {}
        self.lock = threading.Lock()
        self.requested = []
        self.cv = threading.Condition()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while True:
            with self.cv:
                while not self.requested:
                    self.cv.wait()
                # the key stays requested until its result is stored: a
                # request() meanwhile must not queue it again, since a
                # sequential source (a video) cannot go back to it
                number, cam = self.requested[0]
            try:
                img = self.inner.frame(number, cam)
            except Exception as e:  # re-raised in frame()
                img = e
            with self.cv:
                with self.lock:
                    self.results[(number, cam)] = img
                self.requested.pop(0)
                self.cv.notify_all()

    def request(self, number: int, camera_ind: int = 0):
        with self.cv:
            key = (number, camera_ind)
            with self.lock:
                have = key in self.results
            if not have and key not in self.requested:
                self.requested.append(key)
                self.cv.notify_all()

    def frame(self, number: int, camera_ind: int = 0) -> np.ndarray:
        # read-ahead: queue this frame plus the next `lookahead` of the same
        # camera, so decode overlaps the consumer's compute
        for n in range(number, number + 1 + self.lookahead):
            self.request(n, camera_ind)
        key = (number, camera_ind)
        with self.cv:
            while True:
                with self.lock:
                    if key in self.results:
                        break
                self.cv.wait(timeout=0.1)
        with self.lock:
            img = self.results.pop(key)
            # bound the cache: drop any frames older than the one consumed
            for k in [k for k in self.results if k[1] == camera_ind and k[0] < number]:
                self.results.pop(k)
        if isinstance(img, Exception):
            raise img
        return img

    @property
    def shape(self):
        return self.inner.shape


def open_frame_source(path_or_dir: str, reader_threads: bool = False,
                      convert_to_gray: bool = False) -> FrameSource:
    """reader_threads wraps the source in the background prefetch thread
    (reference: -videoReaderThreads, video_input.cpp:151-165);
    convert_to_gray forces grayscale at read time (reference:
    -convertVideoToGray)."""
    if os.path.isdir(path_or_dir):
        if os.path.exists(os.path.join(path_or_dir, "frame_000000_cam0.npy")):
            src = NpyFrameSource(path_or_dir)
        else:
            src = ImageDirSource(path_or_dir)
    else:
        src = VideoFileSource(path_or_dir)
    if convert_to_gray:
        src = GrayConvertingSource(src)
    if reader_threads:
        src = PrefetchingSource(src)
    return src


class GrayConvertingSource(FrameSource):
    """Force grayscale at read time (reference: -convertVideoToGray applied
    inside the video reader, video_input.cpp)."""

    def __init__(self, inner: FrameSource):
        self.inner = inner

    def frame(self, number: int, camera_ind: int = 0) -> np.ndarray:
        img = self.inner.frame(number, camera_ind)
        if img is not None and img.ndim == 3 and img.shape[-1] in (3, 4):
            from ..frontend.image_utils import rgb_to_gray

            img = np.asarray(rgb_to_gray(img[..., :3]))
        return img

    @property
    def shape(self):
        return self.inner.shape
