"""Peak device memory allocated in the window, GB (10^9 bytes):
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(rec):
    return rec.window_peak_bytes / 1e9 if rec.window_peak_bytes else None
