from .timer import Timer
from .checksum import sha256_file


def renice_current_thread(level: int = 10) -> None:
    """Lower the calling thread's CPU priority (Linux: per-thread nice).

    Host pipeline workers (FASTA decode, chunk pack) call this so the
    dispatch thread and the JAX runtime's transfer threads win the cores
    when both are runnable (decode has slack, the device queue does not).
    Best-effort: silently a no-op elsewhere.
    """
    try:
        import os
        import threading

        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), level)
    except (AttributeError, OSError, PermissionError):
        pass
