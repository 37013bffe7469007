"""Device time a step of every device op that is neither a GEMM, nor a
hand-written kernel, nor the batched LU, us: the tendency, the options, the
update and the graph's copies."""


def read(rec):
    return rec.class_us_per_step("pointwise")
