"""setup_s: seconds from the start of the process to the start of the
window: imports, the data's draw, the bulk build, the mix's set-up and
the warm-up batches (with any build or compile they cause)."""


def read(run):
    return run.setup_s
