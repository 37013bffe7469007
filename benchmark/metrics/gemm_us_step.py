"""Device time of the library's matrix-product kernels a step, us, from the
profiler's rows of the traced replays."""


def read(rec):
    return rec.class_us_per_step("gemm")
