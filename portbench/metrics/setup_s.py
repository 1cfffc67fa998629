"""setup_s (s): process start to the window's start: imports, the kernels'
build or load, the weights drawn, the cell's warm-up (and a decode cell's
sessions prefilled)."""


def read(rec):
    return rec.setup_s
