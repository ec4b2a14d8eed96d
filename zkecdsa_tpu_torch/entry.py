"""Entry points of the port, the counterparts of the repository's
``__graft_entry__.py``.

``entry()`` - a forward step on the hottest compute path: the batched
Tom-256 Pedersen commitment (``DeviceParams.commit_tom`` on the comb
kernel), with its inputs.

``dryrun_multichip(n)`` - starts n ranks (``parallel.launch``), builds a
mesh with the two axes (``dp`` over proof instances, ``ring`` over ring
elements and MSM terms) and runs the real pipeline sharded over it: a
``BatchProver.prove`` and a ``BatchVerifier.verify`` of a dp-sharded batch
(and of the batch with message 0 tampered), plus the ring-axis routines
``sharded_gk_total`` and ``sharded_msm``, each checked against host
arithmetic.  Every rank returns its report; they must agree.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import ecdsa
from .bignum import big
from .curves.instances import tomEdwards256
from .ops.curve_ops import nibble_digits, tom_ops
from .ops.field import TOM_N
from .parallel import launch
from .parallel.mesh import make_mesh_2d, sharded_gk_total, sharded_msm
from .protocol.batch import BatchProver, device_params_for, resolve_device
from .protocol.batch_gk import _ring_len, _ring_sharded
from .protocol.batch_verify import BatchVerifier
from .serde import write_json
from .utils import rng
from .zkp_attest_list import SignatureProofList, generate_params_list

__all__ = ["entry", "dryrun_inputs", "dryrun_multichip"]


def _params():
    with rng.deterministic(2026):
        return generate_params_list()


# The forward step's 8 values: numpy.random.RandomState(0).randint(1, 2**30)
# drawn 8 times, the integers of ``__graft_entry__.entry``, written out.
_ENTRY_INTS = (209652397, 398764592, 924231286, 404868289, 441365316, 463622908, 192771780, 417693032)


def entry(device=None):
    """(forward, (vals, blinds)): ``forward`` commits 8 canonical values
    under 8 blindings on ``device`` (CUDA unless the caller names
    another), returning [8, 4, 9] projective Tom-256 points."""
    dev = device_params_for(_params(), resolve_device(device))

    def forward(vals, blinds):
        return dev.commit_tom(vals, blinds)

    return forward, (TOM_N.pack(_ENTRY_INTS, dev.device), TOM_N.pack(_ENTRY_INTS[::-1], dev.device))


def _mesh_dims(n_devices: int) -> tuple[int, int]:
    """(dp, ring) of the dry run: two ring ranks when n is even and at
    least 4, else one dp rank and n ring ranks (reference
    ``__graft_entry__.py:76-81``)."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return n_devices // 2, 2
    return 1, n_devices


def dryrun_inputs(n_proofs: int):
    """The dry run's batch: (params, message hashes, signatures, public
    keys, whichs, ring, tape seeds); instance i proves key i, and the ring
    is the keys padded with 11, 13, 17, 19 to a power of two >= 4."""
    params = _params()
    with rng.deterministic(1234):
        msgs, sigs, pubs, ring = [], [], [], []
        for i in range(n_proofs):
            kp = ecdsa.generate_keypair()
            msg = f"dryrun {i}".encode()
            sigs.append(ecdsa.sign(kp, msg))
            pub = ecdsa.export_public_raw(kp)
            msgs.append(hashlib.sha256(msg).digest())
            pubs.append(pub)
            ring.append(ecdsa.key_to_int(pub))
    ring = (ring + [11, 13, 17, 19])[: max(4, 1 << (n_proofs - 1).bit_length())]
    return params, msgs, sigs, pubs, list(range(n_proofs)), ring, [7_000 + i for i in range(n_proofs)]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _dryrun_rank(rank: int, world: int, device, backend: str) -> dict:
    # one intra-op thread a rank: ranks on one host's CPU share its cores
    torch.set_num_threads(1)
    dp, ringsz = _mesh_dims(world)
    mesh = make_mesh_2d(dp, ringsz, device=device, backend=backend)

    # ---- the real pipeline, dp-sharded: one proof per dp rank ----
    params, msgs, sigs, pubs, whichs, ring, seeds = dryrun_inputs(dp)
    tapes = [rng.DeterministicSource(s) for s in seeds]
    proofs = BatchProver(params, mesh=mesh).prove(msgs, sigs, pubs, whichs, ring, tapes)
    bv = BatchVerifier(params, mesh=mesh)
    ok = bv.verify(msgs, ring, proofs)
    _check(ok == [True] * dp, f"sharded pipeline verify failed: {ok}")
    bad = bv.verify([hashlib.sha256(b"tamper").digest()] + msgs[1:], ring, proofs)
    _check(bad == [False] + [True] * (dp - 1), f"tampered message 0: {bad}")

    # ---- ring-axis routines, against host arithmetic ----
    RING, n_bits = 4 * ringsz, 3
    with rng.deterministic(1):  # the same integers on every rank
        f_ints = [big.rnd_range(1, (1 << 30) - 1) for _ in range(RING * n_bits)]
        v_ints = [big.rnd_range(1, (1 << 30) - 1) for _ in range(RING)]
        msm_sc = [big.rnd_range(1, (1 << 30) - 1) for _ in range(RING)]
    total = sharded_gk_total(mesh, TOM_N.pack(f_ints).reshape(RING, n_bits, -1), TOM_N.pack(v_ints))
    want = 0
    for i in range(RING):
        prod = 1
        for j in range(n_bits):
            prod = prod * f_ints[i * n_bits + j] % TOM_N.p
        want = (want + v_ints[i] * prod) % TOM_N.p
    _check(TOM_N.unpack(total) == [want], "sharded GK total mismatch")
    g = tomEdwards256
    host_pts = [g.generator().mul(g.new_scalar(k + 1)) for k in range(RING)]
    got = sharded_msm(
        mesh, tom_ops, tom_ops.pack_points(host_pts),
        torch.from_numpy(nibble_digits(msm_sc).astype(np.uint8)),
    )
    want_pt = g.identity()
    for pt, sc in zip(host_pts, msm_sc):
        want_pt = want_pt.add(pt.mul(g.new_scalar(sc)))
    _check(tom_ops.unpack_points(got[None].cpu())[0].eq(want_pt), "sharded MSM mismatch")
    return {
        "rank": rank, "mesh": mesh.shape, "device": str(mesh.device), "backend": backend,
        "ring": len(ring), "ring_sharded": _ring_sharded(mesh, _ring_len(len(ring))[0]), "proofs": [write_json(SignatureProofList, p) for p in proofs],
        "verdicts": ok, "tampered": bad,
    }


def dryrun_multichip(n_devices: int, *, device=None, backend: str = "nccl",
                     timeout: float = 1800.0) -> list[dict]:
    """Run the dry run on ``n_devices`` ranks of this host (each on
    ``device``: CUDA card ``rank % device_count`` unless the caller names
    another) over ``backend``; returns every rank's report, after checking
    that they agree."""
    reports = launch.run(_dryrun_rank, n_devices, args=(device, backend), backend=backend,
                         timeout=timeout)
    keys = ("proofs", "verdicts", "tampered")
    _check(all(r[k] == reports[0][k] for r in reports for k in keys), "ranks disagree")
    dp, ringsz = _mesh_dims(n_devices)
    print(
        f"dryrun_multichip({n_devices}): mesh dp={dp} ring={ringsz} over {backend}; "
        f"sharded prove+verify ok for {dp} proofs @ ring {reports[0]['ring']}; "
        f"ring-axis GK total + MSM ok"
    )
    return reports
