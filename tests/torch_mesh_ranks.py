"""Rank functions of the mesh tests (tests/test_torch_mesh.py,
tests/test_torch_mesh_pipeline.py, tests/test_torch_warmup.py, and one
``cuda`` test of tests/test_torch_kernels.py), run by ``zkecdsa_tpu_torch.parallel.launch``
in spawned processes.  This module imports PyTorch and the port only, so
that a rank never loads JAX; each returns plain Python values."""

import numpy as np
import torch

from zkecdsa_tpu_torch.curves.instances import tomEdwards256
from zkecdsa_tpu_torch.ops.curve_ops import tom_ops
from zkecdsa_tpu_torch.ops.field import TOM_N
from zkecdsa_tpu_torch.parallel import mesh as tmesh


def _affine(pts: torch.Tensor) -> list[tuple[int, int]]:
    return [pt.to_affine() for pt in tom_ops.unpack_points(pts.cpu())]


def four(rank: int, world: int, params_json: str, case: dict) -> dict:
    """On a 4-rank world: ``shard_batch``/``replicate`` and
    ``sharded_commit`` on a ``dp`` mesh, ``sharded_gk_total`` and
    ``sharded_msm`` on a ``ring`` mesh."""
    torch.set_num_threads(1)
    from zkecdsa_tpu_torch.protocol.batch import DeviceParams
    from zkecdsa_tpu_torch.serde import read_json
    from zkecdsa_tpu_torch.zkp_attest_list import SystemParametersList

    dp = tmesh.make_mesh(4, "dp", device="cpu", backend="gloo")
    ring = tmesh.make_mesh(4, "ring", device="cpu", backend="gloo")
    out = {"dp_coord": dp.coord("dp"), "ring_coord": ring.coord("ring")}
    try:
        tmesh.shard_batch(dp, torch.zeros(6, 4))
        out["odd_batch"] = "no error"
    except ValueError as e:
        out["odd_batch"] = str(e)
    x = torch.arange(8)[:, None].expand(8, 4)
    out["slice"] = tmesh.shard_batch(dp, x)[:, 0].tolist()
    out["none_is_noop"] = tmesh.shard_batch(None, x) is x
    tree = {"a": torch.ones(3, 2), "b": np.zeros(5, np.float32)}
    rep = tmesh.replicate(dp, tree)
    out["leaves"] = sorted((k, str(v.device), type(v).__name__) for k, v in rep.items())
    out["replicate_none_is_noop"] = tmesh.replicate(None, tree) is tree

    dev = DeviceParams(read_json(SystemParametersList, params_json), "cpu")
    block = tmesh.sharded_commit(dp, dev, TOM_N.pack(case["vals"]), TOM_N.pack(case["blinds"]))
    out["commit"] = _affine(tmesh.gather(dp, block))

    RING, n = case["ring_n"]
    total = tmesh.sharded_gk_total(
        ring, TOM_N.pack(case["factors"]).reshape(RING, n, -1), TOM_N.pack(case["vec"])
    )
    out["gk_total"] = TOM_N.unpack(total)[0]
    g = tomEdwards256
    pts = [g.generator().mul(g.new_scalar(k)) for k in case["msm_points"]]
    digits = torch.from_numpy(np.asarray(case["msm_digits"], np.uint8))
    out["msm"] = _affine(tmesh.sharded_msm(ring, tom_ops, tom_ops.pack_points(pts), digits)[None])[0]
    return out


def eight(rank: int, world: int, case: dict) -> dict:
    """On an 8-rank world, a 2 dp x 4 ring mesh: ``sharded_gk_dvalues``
    and ``sharded_gk_recombine`` with the instances over ``dp``, gathered
    back to the whole batch."""
    torch.set_num_threads(1)
    mesh = tmesh.make_mesh_2d(2, 4, device="cpu", backend="gloo")

    def limbs(ints, *shape):
        return TOM_N.pack(ints).reshape(*shape, -1)

    dv = case["dvalues"]
    N, n, RING = dv["shape"]
    got = tmesh.sharded_gk_dvalues(
        mesh, torch.tensor(dv["eli"], dtype=torch.int32), limbs(dv["ai"], N, n),
        limbs(dv["vals"], RING), limbs(dv["vidx"], N), dp_axis="dp",
    )
    rc = case["recombine"]
    N2, n2, RING2 = rc["shape"]
    tot = tmesh.sharded_gk_recombine(
        mesh, limbs(rc["f"], N2, n2), limbs(rc["xf"], N2, n2), limbs(rc["vals"], RING2), dp_axis="dp",
    )
    # a ring of 4 over the 4 ring ranks: one element a rank, no low bits
    d1 = case["dvalues_1"]
    N1, n1, RING1 = d1["shape"]
    got1 = tmesh.sharded_gk_dvalues(
        mesh, torch.tensor(d1["eli"], dtype=torch.int32), limbs(d1["ai"], N1, n1),
        limbs(d1["vals"], RING1), limbs(d1["vidx"], N1), dp_axis="dp",
    )
    return {
        "coords": (mesh.coord("dp"), mesh.coord("ring")),
        "dvalues": TOM_N.unpack(tmesh.gather(mesh, got)),
        "recombine": TOM_N.unpack(tmesh.gather(mesh, tot)),
        "dvalues_1": TOM_N.unpack(tmesh.gather(mesh, got1)),
    }


def nccl_pair_on_one_card(rank: int, world: int) -> str:
    """Two NCCL ranks, both on ``cuda:0``: the first collective raises
    NCCL's own error (the mesh never switches backend)."""
    mesh = tmesh.make_mesh(2, device="cuda:0", backend="nccl")
    tmesh.gather(mesh, torch.zeros(1, 9, dtype=torch.int32))
    return "gathered"


def second_raises(rank: int, world: int) -> str:
    """Rank 1 raises while rank 0 waits for it in a gather."""
    mesh = tmesh.make_mesh(2, device="cpu", backend="gloo")
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    tmesh.gather(mesh, torch.zeros(1))
    return "gathered"


def warmup_spy(rank: int, world: int, params_json: str, n: int, e: tuple, ring: int) -> dict:
    """``BatchProver.warmup`` on a ``world`` x 1 mesh (gloo, the CPU) with
    spies on ``phase_b`` and ``phase_b_flat``: the calls it made, as
    (name, shape of the last argument)."""
    torch.set_num_threads(1)
    from zkecdsa_tpu_torch.protocol import batch
    from zkecdsa_tpu_torch.serde import read_json
    from zkecdsa_tpu_torch.zkp_attest_list import SystemParametersList

    mesh = tmesh.make_mesh_2d(world, 1, device="cpu", backend="gloo")
    bp = batch.BatchProver(read_json(SystemParametersList, params_json), mesh=mesh)
    calls = []
    for name in ("phase_b", "phase_b_flat"):
        def spy(*args, _fn=getattr(batch, name), _name=name):
            calls.append((_name, tuple(args[-1].shape)))
            return _fn(*args)

        setattr(batch, name, spy)  # this rank's process ends with the call
    bp.warmup(n, e, ring=ring)
    return {"calls": calls}
