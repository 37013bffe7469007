"""The device's idle share of the measured window, %: 1 - the window's
steps times a step's device time (the traced replays run back to back,
timed by CUDA events), over the window's wall time.  The window's output
boundaries (the fetch, the watchdog, the CSV write) count as idle where
the card waits for the host, and the profiler's own cost counts nowhere."""


def read(rec):
    if not rec.step_device_s or not rec.window_wall_s or not rec.window_steps:
        return None
    return 100.0 * (1.0 - rec.step_device_s * rec.window_steps / rec.window_wall_s)
