"""Seconds of the benchmark's span around building the prover's device
parameters (``device_params_for`` under ``BatchProver``); in a checkout's
first run it holds the kernels' build."""


def read(r):
    return r.setup_spans.get("device_params")
