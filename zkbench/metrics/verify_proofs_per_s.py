"""Proofs of all the window's verify batches over the window's wall time
(host clock, from the window's start to the last batch's end, which ends
in a synchronise of the card)."""


def read(r):
    if r.path != "verify" or r.window_s <= 0:
        return None
    return r.proofs / r.window_s
