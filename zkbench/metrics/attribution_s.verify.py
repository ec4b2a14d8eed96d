"""Seconds a verify batch of the MSM attribution pass: the port's span
``msm.attribution``, the per-row rerun after a failed combined check, its
children (``msm.pack_host``, ``msm.upload``, ``msm.digits``,
``msm.device``) included; 0 in a batch whose combined checks all held."""

from zkbench.harness import port_record


def read(r):
    if r.path != "verify":
        return None
    return port_record.span_s(r, "msm.attribution")
