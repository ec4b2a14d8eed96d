"""Seconds from the process's start to the window's: imports, the
instances, the parameters' device tables (and, in a checkout's first run,
the kernels' build), the warm-up and, in a verify cell, the pool's
proofs."""


def read(r):
    return r.setup_s
