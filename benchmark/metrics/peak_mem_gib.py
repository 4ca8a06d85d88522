"""The most device memory the allocator held during the traced run's window,
GiB (``max_memory_allocated`` after a reset at the window's start)."""


def read(t):
    return t.peak_bytes / 2 ** 30 if t.peak_bytes else None
