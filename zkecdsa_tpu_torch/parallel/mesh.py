"""Multi-device sharding on ``torch.distributed``: the port of
``zkecdsa_tpu/parallel/mesh.py``.

Axes, as in the reference:

* ``dp`` - data parallelism over independent proof instances (the batch
  dimension); no collectives in the prove phases, one gather of each
  device output before the host reads it;
* ``ring`` - the ring elements of the Groth-Kohlweiss recombination (and
  the terms of :func:`sharded_msm`); partial sums meet in one gather and
  one fold.

The reference runs under JAX's single controller, which holds global
arrays.  The port is SPMD: one process per rank (``parallel.launch``
starts them), and every rank calls each function with the same full
inputs.  A function slices its rank's share of an input itself
(:func:`shard_batch`); an output sharded over an axis comes back as this
rank's block, which :func:`gather` assembles, and a replicated output
comes back whole on every rank.  Every field value is canonical limbs
(``ops.field``), and each rank computes on its own device,
``Mesh.device``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..ops.curve_ops import msm, sum_reduce
from ..ops.field import NLIMBS, TOM_N, field_mul, field_mul_chain, field_sum, ring_fold

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_2d",
    "shard_batch",
    "replicate",
    "gather",
    "from_first_rank",
    "sharded_commit",
    "sharded_gk_total",
    "sharded_gk_dvalues",
    "sharded_gk_recombine",
    "sharded_msm",
]

fo = TOM_N


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh over the ranks of the default process group, and the
    device this rank computes on."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, like ``jax.sharding.Mesh.shape``."""
        dm = self.device_mesh
        return dict(zip(dm.mesh_dim_names, dm.shape))

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)


def _make(shape: tuple[int | None, ...], names: tuple[str, ...], device, backend: str) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    from ..protocol.batch import resolve_device

    dev = resolve_device(device)  # raises without a card, before any collective
    if not dist.is_initialized():
        dist.init_process_group(backend)  # env:// (torchrun's variables)
    elif dist.get_backend() != backend:
        raise ValueError(
            f"the process group runs {dist.get_backend()!r}, the mesh asks for {backend!r}"
        )
    world = dist.get_world_size()
    shape = tuple(world if s is None else s for s in shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} does not cover the world of {world} ranks")
    if dev.type == "cuda":
        if device is None:  # rank r on card r mod count; ranks may share one
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=names), dev)


def make_mesh(n_devices: int | None = None, axis: str = "dp", *, device=None,
              backend: str = "nccl") -> Mesh:
    """A one-axis mesh over the ``n_devices`` ranks of the process group,
    all of them when None (reference ``mesh.py:44``).  ``device`` is this
    rank's device: CUDA unless the caller names another (card ``rank %
    device_count`` when None).  If no launcher started the process group,
    it starts on ``backend`` from torchrun's environment; a group on
    another backend raises.  Nothing switches backend or device on a
    failure."""
    return _make((n_devices,), (axis,), device, backend)


def make_mesh_2d(dp: int, ring: int, *, device=None, backend: str = "nccl") -> Mesh:
    """A ``dp`` x ``ring`` mesh (reference ``mesh.py:51``); ``ring`` is
    the inner axis, so the ranks of one ``ring`` line are consecutive."""
    return _make((dp, ring), ("dp", "ring"), device, backend)


def shard_batch(mesh: Mesh | None, x, axis: str = "dp"):
    """This rank's slice of the leading axis of ``x`` (a tensor, array or
    list) over ``axis`` (reference ``mesh.py:56``).  No-op when ``mesh``
    is None; the batch must divide evenly - nothing is padded."""
    if mesh is None:
        return x
    n = mesh.shape[axis]
    if len(x) % n != 0:
        raise ValueError(
            f"batch dim {len(x)} not divisible by mesh axis '{axis}' size {n}; pad the batch"
        )
    step = len(x) // n
    c = mesh.coord(axis)
    return x[c * step : (c + 1) * step]


def replicate(mesh: Mesh | None, tree):
    """Every tensor leaf of a dict/list/tuple tree on this rank's device
    (numpy arrays become tensors; objects with ``.to``, such as
    ``MixedComb``, move whole).  No-op when ``mesh`` is None."""
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    return tree.to(mesh.device)


def gather(mesh: Mesh | None, x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """The blocks of every rank along ``axis``, concatenated on the
    leading axis in coordinate order (the inverse of :func:`shard_batch`),
    on this rank's device: one ``all_gather`` on the axis's group.
    No-op when ``mesh`` is None."""
    if mesh is None:
        return x
    x = x.to(mesh.device).contiguous()
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, wire, group=mesh.group(axis))
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def from_first_rank(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ``x`` of the mesh's first rank (coordinate 0 on every axis), on
    every rank: one gather per axis."""
    for axis in mesh.shape:
        x = gather(mesh, x[None], axis)[0]
    return x


# ---------------------------------------------------------------------------
# the sharded routines (reference mesh.py:82-285)
# ---------------------------------------------------------------------------


def sharded_commit(mesh: Mesh, dev_params, vals: torch.Tensor, blinds: torch.Tensor) -> torch.Tensor:
    """Pedersen commitments g*v + h*r (canonical [B, 9] values and
    blindings) with the batch sharded over ``dp``: this rank commits its
    block on ``comb_mixed`` (``DeviceParams.commit_tom``); no collective.
    Returns this rank's [B/dp, 4, 9] block."""
    dev = mesh.device
    return dev_params.commit_tom(shard_batch(mesh, vals).to(dev), shard_batch(mesh, blinds).to(dev))


def sharded_gk_total(mesh: Mesh, f_or_xf: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """sum_i vec_i * prod_j f_or_xf[i, j] mod the Tom-256 order (the GK
    verifier's recombination, gk.ts:239-250) with the ring elements
    sharded over ``ring``: factors [RING, n, 9], values [RING, 9] ->
    the total [9], on every rank.  Each rank multiplies each of its
    shard's values by its n factors in one launch (``field_mul_chain``),
    sums its terms (``field_sum``); the partial sums meet in one gather
    and one ``field_sum``."""
    dev = mesh.device
    factors = shard_batch(mesh, f_or_xf, "ring").to(dev)
    values = shard_batch(mesh, vec, "ring").to(dev)
    local = field_sum(fo, field_mul_chain(fo, values, factors)[:, None])  # [1, 9]
    return field_sum(fo, gather(mesh, local[None], "ring"))[0]


def _ring_shard(mesh: Mesh, values: torch.Tensor, ring_axis: str):
    """This rank's contiguous ring slice, the index bits it resolves
    itself (the low ``n_low``) and its coordinate, whose bits select the
    high-bit factors (global index i = coord * localR + r)."""
    vals = shard_batch(mesh, values, ring_axis).to(mesh.device)
    return vals, (vals.shape[0] - 1).bit_length(), mesh.coord(ring_axis)


def sharded_gk_dvalues(
    mesh: Mesh,
    eli: torch.Tensor,  # [N, n] index bits, LSB first
    ai: torch.Tensor,  # [N, n, 9]
    values: torch.Tensor,  # [RING, 9] padded ring (sharded over ``ring_axis``)
    v_index: torch.Tensor,  # [N, 9] values[which] per instance
    dp_axis: str | None = None,
    ring_axis: str = "ring",
) -> torch.Tensor:
    """The GK prover's d-polynomial values at omega = 0..n-1 (gk.ts:
    135-171) with the ring elements sharded over ``ring_axis`` and,
    optionally, the instances over ``dp_axis``: [N, n, 9] canonical, or
    this rank's dp block.  Equal to ``protocol.batch_gk.gk_dvalues_device``.

    As there, the factors f0_j(w) = (1-el_j)w - a_j and f1_j(w) = el_j w +
    a_j are host integers.  Each rank contracts its ring slice over the
    low index bits (``ring_fold``), multiplies by the product of the high
    bits' factors that its ring coordinate selects (one ``field_mul``),
    and the partial folds meet in one gather and one ``field_sum``; then
    d(w) = v_index * w^n - fold on the host (sum_i p_i(w) = w^n)."""
    p = fo.p
    dev = mesh.device
    if dp_axis is not None:
        eli, ai, v_index = (shard_batch(mesh, t, dp_axis) for t in (eli, ai, v_index))
    vals, n_low, c = _ring_shard(mesh, values, ring_axis)
    N, n = eli.shape
    el = eli.tolist()
    a = fo.unpack(ai)
    f0s, f1s, his = [], [], []
    for i in range(N):
        for w in range(n):
            f0 = [((1 - el[i][j]) * w - a[i * n + j]) % p for j in range(n)]
            f1 = [(el[i][j] * w + a[i * n + j]) % p for j in range(n)]
            f0s += f0[:n_low]
            f1s += f1[:n_low]
            hi = 1
            for j in range(n_low, n):
                hi = hi * (f1[j] if (c >> (j - n_low)) & 1 else f0[j]) % p
            his.append(hi)
    local = ring_fold(
        vals,
        fo.pack(f1s, dev).reshape(N * n, n_low, NLIMBS),
        fo.pack(f0s, dev).reshape(N * n, n_low, NLIMBS),
    )
    local = field_mul(fo, local, fo.pack(his, dev))
    fold = fo.unpack(field_sum(fo, gather(mesh, local[None], ring_axis)))
    v = fo.unpack(v_index)
    d = [(v[i] * pow(w, n, p) - fold[i * n + w]) % p for i in range(N) for w in range(n)]
    return fo.pack(d, dev).reshape(N, n, -1)


def sharded_gk_recombine(
    mesh: Mesh,
    f: torch.Tensor,  # [N, n, 9] response scalars
    xf: torch.Tensor,  # [N, n, 9] x - f
    values: torch.Tensor,  # [RING, 9] (sharded over ``ring_axis``)
    dp_axis: str | None = None,
    ring_axis: str = "ring",
) -> torch.Tensor:
    """The GK verifier's recombination sum_i v_i * prod_j (f_j if
    bit_j(i) else x-f_j) with the ring elements sharded over
    ``ring_axis`` (and, optionally, the instances over ``dp_axis``):
    [N, 9] canonical, or this rank's dp block.  Each rank runs
    ``ring_fold`` over its slice and the low index bits, multiplies by the
    high bits' factors its ring coordinate selects (stacked, one
    ``field_mul_chain`` launch for any ring size), and the partials meet
    in one gather and one ``field_sum``.  Equal to
    ``protocol.batch_gk.gk_recombine_device``."""
    dev = mesh.device
    if dp_axis is not None:
        f, xf = shard_batch(mesh, f, dp_axis), shard_batch(mesh, xf, dp_axis)
    f, xf = f.to(dev), xf.to(dev)
    vals, n_low, c = _ring_shard(mesh, values, ring_axis)
    local = ring_fold(vals, f[:, :n_low], xf[:, :n_low])
    if f.shape[1] > n_low:
        high = [f[:, j] if (c >> (j - n_low)) & 1 else xf[:, j] for j in range(n_low, f.shape[1])]
        local = field_mul_chain(fo, local, torch.stack(high, 1))
    return field_sum(fo, gather(mesh, local[None], ring_axis))


def sharded_msm(mesh: Mesh, ops, points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """sum_i s_i * P_i with the terms sharded over ``ring``: points
    [T, C, 9], MSB-first nibbles [T, 64] -> [C, 9] on every rank.  Each
    rank sums its terms on ``msm`` (``straus_msm`` on one row); the
    partial points are gathered and folded with ``tree_sum``
    (``sum_reduce``)."""
    dev = mesh.device
    local = msm(ops, shard_batch(mesh, points, "ring").to(dev), shard_batch(mesh, digits, "ring").to(dev))
    return sum_reduce(ops, gather(mesh, local[None], "ring"), axis=0)
