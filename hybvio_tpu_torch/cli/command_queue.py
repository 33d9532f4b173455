"""Interactive command queue (a copy of the reference package's
``cli/command_queue.py``; reference: src/commandline/command_queue.cpp):
keyboard -> typed commands consumed by the runner's main loop, with a
step-mode gate."""
from __future__ import annotations

import enum
import queue
import threading
from typing import Optional


class Command(enum.Enum):
    NONE = 0
    QUIT = 1
    POSE = 2
    STEP_MODE = 3
    LOCK_BIASES = 4
    ROTATE = 5
    CONDITION_ON_LAST_POSE = 6
    PAUSE_CAMERA = 7
    ANY_KEY = 8


KEYMAP = {
    "q": Command.QUIT,
    "p": Command.POSE,
    "s": Command.STEP_MODE,
    "b": Command.LOCK_BIASES,
    "r": Command.ROTATE,
    "c": Command.CONDITION_ON_LAST_POSE,
    " ": Command.PAUSE_CAMERA,
}


class CommandQueue:
    def __init__(self):
        self.q: "queue.Queue[Command]" = queue.Queue()
        self.step_mode = False
        self._step_event = threading.Event()

    def push_key(self, key: str) -> None:
        cmd = KEYMAP.get(key, Command.ANY_KEY)
        if cmd == Command.STEP_MODE:
            self.step_mode = not self.step_mode
        if self.step_mode and cmd == Command.ANY_KEY:
            self._step_event.set()
            return
        self.q.put(cmd)

    def poll(self) -> Command:
        try:
            return self.q.get_nowait()
        except queue.Empty:
            return Command.NONE

    def wait_for_step(self, timeout: Optional[float] = None) -> bool:
        """Block while in step mode until any key (reference: step-mode
        blocking in command_queue.cpp)."""
        if not self.step_mode:
            return True
        ok = self._step_event.wait(timeout)
        self._step_event.clear()
        return ok
