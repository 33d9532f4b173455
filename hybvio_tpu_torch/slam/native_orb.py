"""The reference package's ``slam/native_orb.py`` (a ctypes binding of the
C++ multi-scale ORB detector in ``native/``) is not ported: the port's
session always runs its torch detector (``slam/keypoints.py``), on the
session's device. Asking for the native one raises."""
from __future__ import annotations


def native_orb_available() -> bool:
    """Never: the binding is not ported."""
    return False


def make_native_orb(*args, **kwargs):
    raise NotImplementedError("slam/native_orb.py: the native C++ ORB detector is not ported; "
                              "the session runs slam/keypoints.py make_multiscale_orb")
