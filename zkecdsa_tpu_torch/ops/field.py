"""Modular arithmetic on limb tensors: the port's counterpart of
``zkecdsa_tpu/ops/f32field.py``.

Representation
--------------
At every public boundary (kernel inputs and outputs, host packing) a field
element is nine little-endian 32-bit limbs in an ``int32`` tensor
``[..., 9]`` (the bit pattern of a ``uint32``), canonical: the value is in
[0, p), in standard (not Montgomery) form.  Nine limbs because the Tom-256
base prime is 258 bits.  Canonical limbs make the 4-bit window digits and
the comb's byte digits a reinterpretation of the limbs (:func:`bytes_le`),
not a computation.  Two exceptions, point tables held in the kernels'
Montgomery form (x * 2^288 mod p, :meth:`FieldT.pack_mont`) so that a
kernel reads an entry without converting it: the comb tables built once
per parameter set (in both forms), and on the card the per-prove comb4
tables, which one kernel writes and the next reads.  The wrapper that
takes such a table says which form each side holds.

The kernels (``csrc/field.cuh``) compute in Montgomery form inside a
thread.  The plain PyTorch versions here compute the same functions in
``int64`` with 16-bit digits in a *redundant* working form: width
``W = lp + 2`` digits (``lp`` = the modulus width in digits), every digit
at most ``D = 2^18``, value congruent mod p.  Each operation ends with a
fixed schedule of carry rounds and folds (``2^(16(W+t)) mod p`` rows) that
restores that invariant.  The schedule is derived once per modulus by
tracking per-position bounds with Python integers (:meth:`FieldT._plan`),
which also proves that no intermediate leaves ``int64``.  Only
:meth:`FieldT.canon` (quotient estimate plus an exact ripple) returns to
canonical values, at the function boundary.

Kernel wrappers
---------------
:func:`field_mul` (``csrc/field.cu``) and its chain form
:func:`field_mul_chain`; :func:`ring_fold` (``csrc/field.cu``), the GK ring
contraction in one launch; :func:`field_sum` (``csrc/field.cu``), the sum
over a leading axis that folds the sharded GK partials; :func:`field_plan`,
their launch geometry.  A CPU tensor takes the plain version; any other
tensor launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build

__all__ = [
    "FieldT",
    "P256_P",
    "P256_N",
    "TOM_P",
    "TOM_N",
    "WAR_P",
    "NLIMBS",
    "FieldPlan",
    "field_plan",
    "field_mul",
    "field_mul_plain",
    "field_mul_chain",
    "field_mul_chain_plain",
    "field_sum",
    "field_sum_plain",
    "ring_fold",
    "ring_fold_plain",
    "bytes_le",
]

NLIMBS = 9  # 32-bit limbs per element at the kernel boundary
_DB = 16  # plain working digit: 16 bits in int64
_DM = (1 << _DB) - 1
_D = 1 << 18  # working-form digit bound
_I64_SAFE = 1 << 62


def _digits_of(x: int, n: int) -> list[int]:
    return [(x >> (_DB * i)) & _DM for i in range(n)]


class FieldT:
    """Modular arithmetic context for one modulus (see module docstring).
    ``mod_id`` selects the modulus inside the kernels (csrc/field.cuh)."""

    def __init__(self, name: str, p: int, mod_id: int) -> None:
        self.name = name
        self.p = p
        self.mod_id = mod_id
        self.lp = -(-p.bit_length() // _DB)  # modulus width in digits
        self.W = self.lp + 2  # working width
        W = self.W
        if 2 * NLIMBS < self.lp or W < 2 * NLIMBS:
            raise ValueError("modulus does not fit the 9-limb layout")
        # fold rows anchored at the working width (operations) and at the
        # modulus width (canon)
        self._red = [_digits_of(pow(2, _DB * (W + t), p), W) for t in range(W + 4)]
        self._red_lp = [
            _digits_of(pow(2, _DB * (self.lp + t), p), self.lp) for t in range(4)
        ]
        # PADP: a multiple of p whose every digit is in [D, 2D]; a - b is
        # computed as a + (PADP - b), which keeps every digit >= 0
        V = sum((2 * _D) << (_DB * k) for k in range(W))
        rem = _digits_of(V % p, W)
        self._padp = [2 * _D - r for r in rem]
        assert min(self._padp) >= _D and sum(
            d << (_DB * k) for k, d in enumerate(self._padp)
        ) % p == 0
        # reduction schedules, proved against int64 overflow by _plan
        conv = lambda m: [  # noqa: E731  column bounds of a product
            min(k + 1, W, 2 * W - 1 - k) * m * m for k in range(2 * W - 1)
        ]
        self._plans = {
            "mul": self._plan(conv(3 * _D)),  # inputs may be lazy sums
            "x2": self._plan([2 * _D] * W),
            "x3": self._plan([3 * _D] * W),
            "x4": self._plan([4 * _D] * W),
        }
        self._dev: dict[torch.device, dict[str, torch.Tensor]] = {}

    def __repr__(self) -> str:
        return f"FieldT({self.name})"

    # ---------- host <-> limb tensors ----------

    def pack(self, values, device=None) -> torch.Tensor:
        """Python ints -> [N, 9] int32 canonical limbs."""
        p = self.p
        buf = b"".join((int(v) % p).to_bytes(4 * NLIMBS, "little") for v in values)
        arr = np.frombuffer(buf, dtype="<i4").reshape(len(values), NLIMBS)
        return torch.from_numpy(arr.astype(np.int32)).to(device or "cpu")

    def pack_mont(self, values, device=None) -> torch.Tensor:
        """Python ints -> [N, 9] limbs of x * 2^288 mod p: the Montgomery
        form of the kernels (csrc/field.cuh), for constant tables that a
        kernel reads as they stand."""
        R = 1 << (32 * NLIMBS)
        return self.pack([int(v) * R for v in values], device)

    def unpack(self, t: torch.Tensor) -> list[int]:
        """Canonical [..., 9] limbs -> Python ints (flattened leading dims)."""
        a = t.detach().to("cpu").contiguous().numpy().astype("<i4")
        by = a.reshape(-1, NLIMBS).tobytes()
        n = 4 * NLIMBS
        return [int.from_bytes(by[i : i + n], "little") for i in range(0, len(by), n)]

    def const(self, v: int, device=None) -> torch.Tensor:
        """One canonical constant as a [9] tensor."""
        return self.pack([v], device)[0]

    # ---------- constants on a device ----------

    def _c(self, device: torch.device) -> dict[str, torch.Tensor]:
        c = self._dev.get(device)
        if c is None:
            i64 = dict(dtype=torch.int64, device=device)
            W = self.W
            p_dig = _digits_of(self.p, self.lp + 1)
            c = {
                "red": torch.tensor(self._red, **i64),
                "red_lp": torch.tensor(self._red_lp, **i64),
                "padp": torch.tensor(self._padp, **i64),
                "p": torch.tensor(p_dig, **i64),
                "p2": torch.tensor(_digits_of(2 * self.p, self.lp + 1), **i64),
                # 2^(16k) / p, for the canon quotient estimate
                "pw": torch.tensor(
                    [float(1 << (_DB * k)) / self.p for k in range(self.lp)],
                    dtype=torch.float64, device=device,
                ),
                "lex": 1 << torch.arange(self.lp + 1, **i64),
                # anti-diagonal masks of the [W+1, W] product layout
                "lowm": (
                    torch.arange(W + 1, **i64)[:, None]
                    <= torch.arange(W, **i64)[None, :]
                ).to(torch.int64),
            }
            self._dev[device] = c
        return c

    # ---------- reduction schedule ----------

    def _plan(self, bounds: list[int]) -> list[tuple[str, int]]:
        """Carry/fold steps that bring digits with these per-position
        bounds back to the working form (width W, digits <= D), derived
        with exact integer bounds (the f32 engine's ``_reduce`` logic,
        run once here rather than on every call)."""
        W, red = self.W, self._red
        b = list(bounds)
        steps: list[tuple[str, int]] = []
        for _ in range(64):
            assert max(b) < _I64_SAFE
            if len(b) == W and max(b) <= _D:
                return steps
            if len(b) > W:
                rows = len(b) - W
                nb = [
                    b[k] + sum(b[W + t] * red[t][k] for t in range(rows))
                    for k in range(W)
                ]
                if max(nb) < _I64_SAFE and (max(nb) <= _D or max(b) <= 4 * _D):
                    steps.append(("fold", rows))
                    b = nb
                    continue
            nb = [min(b[0], _DM)]
            nb += [min(b[i], _DM) + (b[i - 1] >> _DB) for i in range(1, len(b))]
            nb.append(b[-1] >> _DB)
            while nb[-1] == 0:
                nb.pop()
            steps.append(("carry", len(nb)))
            b = nb
        raise AssertionError(f"{self.name}: reduction did not converge")

    @staticmethod
    def _carry(x: torch.Tensor, width: int) -> torch.Tensor:
        out = F.pad(x & _DM, (0, 1)) + F.pad(x >> _DB, (1, 0))
        return out[..., :width]

    def _run(self, x: torch.Tensor, plan: str) -> torch.Tensor:
        W = self.W
        for op, n in self._plans[plan]:
            if op == "carry":
                x = self._carry(x, n)
            else:
                red = self._c(x.device)["red"][:n]
                x = x[..., :W] + (x[..., W : W + n, None] * red).sum(-2)
        return x

    # ---------- working-form arithmetic (plain versions) ----------
    #
    # Inputs are working-form digits [..., W]; ``*_lazy`` results skip the
    # reduction and may feed only ``wmul`` (inputs up to 3D).

    def to_work(self, x: torch.Tensor) -> torch.Tensor:
        """Canonical [..., 9] int32 limbs -> working digits [..., W]."""
        u = x.to(torch.int64) & 0xFFFFFFFF
        d = torch.stack([u & _DM, u >> _DB], dim=-1).flatten(-2)
        return F.pad(d, (0, self.W - 2 * NLIMBS))

    def wmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        W = self.W
        outer = a[..., :, None] * b[..., None, :]  # [..., W, W]
        # anti-diagonal sums: pad rows to W+1 and view as [W+1, W]; entry
        # (i, j) lands in column (i+j) mod W, below the diagonal when
        # i + j >= W (f32field._conv_reshape)
        g = F.pad(outer, (0, 1)).reshape(outer.shape[:-2] + (W + 1, W))
        low = self._c(a.device)["lowm"]
        lo = (g * low).sum(-2)
        hi = (g * (1 - low)).sum(-2)
        return self._run(torch.cat([lo, hi[..., : W - 1]], dim=-1), "mul")

    def wadd(self, a, b):
        return self._run(a + b, "x2")

    def wadd_lazy(self, a, b):
        return a + b

    def wsub(self, a, b):
        return self._run(a + (self._c(a.device)["padp"] - b), "x3")

    def wsub_lazy(self, a, b):
        return a + (self._c(a.device)["padp"] - b)

    def wneg(self, a):
        return self._run(self._c(a.device)["padp"] - a, "x2")

    def wsmall(self, a, k: int):
        """k * a for k in 2..4."""
        return self._run(a * k, f"x{k}")

    def wpow(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e (e >= 1), square-and-multiply, MSB first."""
        acc = a
        for bit in bin(e)[3:]:
            acc = self.wmul(acc, acc)
            if bit == "1":
                acc = self.wmul(acc, a)
        return acc

    def winv(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat inverse a^(p-2); 0 maps to 0."""
        return self.wpow(a, self.p - 2)

    def wbatch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Inverses of working digits [n, W] with one Fermat inverse in
        all (the reference's ``batch_inv``, on a product tree: pairwise
        products up to the root, its inverse, then inv(left) = inv(parent)
        * right down again, about 3n products); 0 maps to 0."""
        zero = self.is_zero(self.canon(a))
        one = self.to_work(self.const(1, a.device))
        x = torch.where(zero[:, None], one, a)
        levels = []  # each level padded to an even length with ones
        while x.shape[0] > 1:
            if x.shape[0] % 2:
                x = torch.cat([x, one[None]])
            levels.append(x)
            x = self.wmul(x[0::2], x[1::2])
        inv = self.winv(x)
        for x in reversed(levels):
            inv = inv[: x.shape[0] // 2]  # drop the parent level's padding
            inv = torch.stack([self.wmul(inv, x[1::2]), self.wmul(inv, x[0::2])], dim=1).flatten(0, 1)
        return torch.where(zero[:, None], torch.zeros_like(a), inv[: a.shape[0]])

    def _ripple(self, r: torch.Tensor) -> torch.Tensor:
        """Exact carry propagation of signed digits (floor semantics)."""
        out = torch.empty_like(r)
        carry = torch.zeros_like(r[..., 0])
        for k in range(r.shape[-1]):
            t = r[..., k] + carry
            out[..., k] = t & _DM
            carry = t >> _DB
        return out

    def _geq(self, r: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """r >= m for normalized digit vectors (most significant differing
        digit decides: its weight 2^k exceeds all lower weights together)."""
        return (torch.sign(r - m) * self._c(r.device)["lex"]).sum(-1) >= 0

    def canon(self, x: torch.Tensor) -> torch.Tensor:
        """Working digits -> canonical [..., 9] int32 limbs."""
        c = self._c(x.device)
        lp = self.lp
        x = self._carry(self._carry(x, self.W + 1), self.W + 2)
        # fold at the modulus width: value < 2^(16 lp + 1) + 2^20 p
        x = x[..., :lp] + (x[..., lp:, None] * c["red_lp"][: x.shape[-1] - lp]).sum(-2)
        q = torch.floor((x.to(torch.float64) * c["pw"]).sum(-1))
        q = torch.clamp(q - 1, min=0).to(torch.int64)  # under-estimate
        r = F.pad(x, (0, 1)) - q[..., None] * c["p"]
        r = self._ripple(r)  # in [0, 3p)
        k = self._geq(r, c["p"]).to(torch.int64) + self._geq(r, c["p2"]).to(torch.int64)
        r = self._ripple(r - k[..., None] * c["p"])
        d = F.pad(r[..., :lp], (0, 2 * NLIMBS - lp)).reshape(r.shape[:-1] + (NLIMBS, 2))
        v = d[..., 0] | (d[..., 1] << _DB)
        return (v - ((v >> 31) << 32)).to(torch.int32)

    # ---------- plain versions on canonical limbs ----------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.canon(self.wmul(self.to_work(a), self.to_work(b)))

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.canon(self.wadd(self.to_work(a), self.to_work(b)))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.canon(self.wsub(self.to_work(a), self.to_work(b)))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.canon(self.wneg(self.to_work(a)))

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        return self.canon(self.winv(self.to_work(a)))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Canonical limbs of a * 2^-288 mod p: a table a kernel wrote in
        its Montgomery form (:meth:`pack_mont`), back in standard form."""
        return self.mul(a, self.const(pow(1 << (32 * NLIMBS), -1, self.p), a.device))

    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(-1)

    @staticmethod
    def equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(-1)


# ---- the moduli of the two-curve design (ids as in csrc/field.cuh) ----

_P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
_P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_TOM_P = 0x3FFFFFFFC000000040000000000000002AE382C7957CC4FF9713C3D82BC47D3AF
_WAR_P = 0xFFFFFFFF0000000100000000000000017E72B42B30E7317793135661B1C4B117

P256_P = FieldT("p256.p", _P256_P, 0)  # P-256 base field
P256_N = FieldT("p256.n", _P256_N, 1)  # P-256 scalar field
TOM_P = FieldT("tom.p", _TOM_P, 2)  # Tom-256 base field (258-bit)
TOM_N = FieldT("tom.n", _P256_P, 3)  # Tom-256 scalar field == P-256 base
WAR_P = FieldT("war.p", _WAR_P, 4)  # war256 base field


def bytes_le(x: torch.Tensor, width: int = 32) -> torch.Tensor:
    """LSB-first byte digits of canonical limbs: [..., 9] int32 ->
    [..., width] uint8, a reinterpretation of the little-endian limbs."""
    return x.contiguous().view(torch.uint8)[..., :width]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_limbs(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.int32 or t.shape[-1] != NLIMBS:
            raise ValueError(f"expected int32 [..., {NLIMBS}] limbs, got {t.dtype} {tuple(t.shape)}")
        if t.device.type != "cuda":
            raise ValueError(f"kernel operand on {t.device}, expected a CUDA tensor")
        if t.stride(-1) != 1:
            raise ValueError("limb axis must be contiguous")


def _as_nk(t: torch.Tensor, shape: torch.Size):
    """A broadcast operand as an [N, K, 9] view: (tensor, stride0, stride1)."""
    t = t.expand(shape)
    if len(shape) == 2:
        t = t[None]
    elif len(shape) != 3:
        t = t.reshape(1, -1, NLIMBS)
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride(0), t.stride(1)


def field_mul_plain(f: FieldT, a, b, d=None, e=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`field_mul`, on any device."""
    ops = [a, b] if d is None else [a, b, d, e]
    shape = torch.broadcast_shapes(*(t.shape for t in ops))
    if d is None:
        return f.mul(a, b).expand(shape)
    w = f.wadd(f.wmul(f.to_work(a), f.to_work(b)), f.wmul(f.to_work(d), f.to_work(e)))
    return f.canon(w).expand(shape)


SUM_ROW_MAX_D = 8  # field_sum: a thread a row up to this many terms, a block a row past them


@dataclasses.dataclass(frozen=True)
class FieldPlan:
    """Launch geometry of the field kernels (``csrc/field.cu``):
    ``threads`` a block, and ``lanes`` threads a row: 1 for a thread a row
    (``field_mul``, its chain form, ``field_sum`` up to SUM_ROW_MAX_D
    terms), else a block of ``lanes`` threads a row (``field_sum`` past
    them)."""

    threads: int
    lanes: int = 1


def field_plan(rows: int, sms: int, terms: int = 1) -> FieldPlan:
    """The geometry for ``rows`` output rows of ``terms`` terms each on a
    card of ``sms`` SMs.  A thread a row: the largest block of 256, 128 or
    64 threads that still gives every SM two blocks, else 32, so that the
    mesh's calls of 128-2048 rows run on 4-64 SMs, not 1-8 (one SM's
    schedulers would serialise what the card can run side by side).  Past
    SUM_ROW_MAX_D terms: a block a row, a lane a share of about 4 terms
    (the power of two >= terms / 4, within 32-512: at [2048, 1] 512 lanes
    took 2.9 us on the H100, 256 3.4, 1024 3.4, 128 4.7;
    tools/torch_field_probe.py, PERF.md)."""
    if terms > SUM_ROW_MAX_D:
        lanes = min(512, max(32, 1 << (-(-terms // 4) - 1).bit_length()))
        return FieldPlan(threads=lanes, lanes=lanes)
    for threads in (256, 128, 64):
        if -(-rows // threads) >= 2 * sms:
            return FieldPlan(threads=threads)
    return FieldPlan(threads=32)


_SMS: dict[torch.device, int] = {}


def _sms(device: torch.device) -> int:
    """The SM count of a CUDA device (read once)."""
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def field_mul(f: FieldT, a, b, d=None, e=None) -> torch.Tensor:
    """c = a*b mod p, or the pair form c = a*b + d*e mod p, over canonical
    [..., 9] limbs (operands broadcast).

    Kernel ``csrc/field.cu`` (replaces ``zkecdsa_tpu/ops/pallas_field.py:183
    pallas_mul``): a thread a row in blocks of :func:`field_plan`'s size;
    the P-256 prime (``P256_P``, ``TOM_N``) by Solinas reduction, the other
    moduli by Montgomery products.  A CPU tensor takes the plain
    version."""
    if a.device.type == "cpu":
        return field_mul_plain(f, a, b, d, e)
    ops = [a, b] if d is None else [a, b, d, e]
    shape = torch.broadcast_shapes(*(t.shape for t in ops))
    lib = _build.load()
    _check_limbs(*ops)
    views = [_as_nk(t, shape) for t in ops]
    N, K = views[0][0].shape[0], views[0][0].shape[1]
    out = torch.empty((N, K, NLIMBS), dtype=torch.int32, device=a.device)
    args = []
    for i in range(4):
        if i < len(views):
            t, s0, s1 = views[i]
            args += [t.data_ptr(), s0, s1]
        else:
            args += [None, 0, 0]
    # the x axis of the grid covers K: no wider a block than K needs
    threads = min(field_plan(N * K, _sms(a.device)).threads, max(32, 1 << (K - 1).bit_length()))
    code = lib.zk_field_mul(
        f.mod_id, N, K, *args, out.data_ptr(), threads,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(code, "zk_field_mul")
    field_mul.launches += 1
    return out.reshape(shape)


field_mul.launches = 0


def field_mul_chain_plain(f: FieldT, values: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`field_mul_chain`, on any
    device: a loop of :func:`field_mul_plain` over the factors."""
    out = values.clone()
    for j in range(factors.shape[1]):
        out = field_mul_plain(f, out, factors[:, j])
    return out


def field_mul_chain(f: FieldT, values: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """values[r] * prod_j factors[r, j] mod p: values [R, 9] and factors
    [R, n, 9] canonical -> [R, 9] canonical (n = 0 gives the values).

    ``field_mul``'s chain form, one launch of ``csrc/field.cu`` (replaces
    the ``fo.mul`` loop of ``zkecdsa_tpu/parallel/mesh.py:122-125``, n
    launches through HBM): a thread a row keeps its running product in
    registers.  Its launches count in ``field_mul.launches``.  A CPU
    tensor takes :func:`field_mul_chain_plain`."""
    if values.device.type == "cpu":
        return field_mul_chain_plain(f, values, factors)
    lib = _build.load()
    _check_limbs(values, factors)
    if values.dim() != 2 or factors.dim() != 3 or factors.shape[0] != values.shape[0]:
        raise ValueError(
            f"expected values [R, 9] and factors [R, n, 9], got {tuple(values.shape)}, {tuple(factors.shape)}"
        )
    values, factors = values.contiguous(), factors.contiguous()
    R, n = factors.shape[0], factors.shape[1]
    out = torch.empty_like(values)
    code = lib.zk_field_mul_chain(
        f.mod_id, R, n, values.data_ptr(), factors.data_ptr(), out.data_ptr(),
        field_plan(R, _sms(values.device)).threads, torch.cuda.current_stream(values.device).cuda_stream,
    )
    _build.check(code, "zk_field_mul_chain")
    field_mul.launches += 1
    return out


def ring_fold_plain(values: torch.Tensor, f: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`ring_fold`, on any device: the
    ring axis contracts one index bit at a time, LSB first
    (``zkecdsa_tpu/protocol/batch_gk.py:66 _fold_ring``), level j one
    pair-form :func:`field_mul_plain` over [N, RING/2^(j+1)] rows,
    T'[k] = xf_j * T[2k] + f_j * T[2k+1]."""
    N, n = f.shape[0], f.shape[1]
    if values.shape[0] != 1 << n:
        raise ValueError("ring length must be 2^n for n factors")
    T = values[None].expand(N, values.shape[0], NLIMBS)
    for j in range(n):
        K = T.shape[1] // 2
        T = field_mul_plain(
            TOM_N,
            xf[:, j : j + 1].expand(N, K, NLIMBS), T[:, 0::2],
            f[:, j : j + 1].expand(N, K, NLIMBS), T[:, 1::2],
        )
    return T[:, 0].contiguous() if n else T[:, 0].clone()


_RING_FOLD_MAXN = 32  # csrc/field.cu RF_MAXN: factors a row


def ring_fold(values: torch.Tensor, f: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """sum_i values_i * prod_j (f_j if bit_j(i) else xf_j) mod TOM_N:
    values [2^n, 9], f/xf [N, n, 9] -> [N, 9] canonical, for any n >= 0
    (n = 0 gives the values row on every row).

    Kernel ``csrc/field.cu`` (replaces ``zkecdsa_tpu/protocol/batch_gk.py:66
    _fold_ring``): one launch, a block a row, the row's factors in
    Montgomery form in shared memory, so each of the 2^n - 1 outputs a row
    costs the 2 products and 1 add the bound counts, and no level goes to
    HBM.  A CPU tensor takes :func:`ring_fold_plain`."""
    if values.device.type == "cpu":
        return ring_fold_plain(values, f, xf)
    lib = _build.load()
    _check_limbs(values, f, xf)
    N, n = f.shape[0], f.shape[1]
    if f.dim() != 3 or tuple(xf.shape) != tuple(f.shape) or tuple(values.shape) != (1 << n, NLIMBS):
        raise ValueError(
            f"expected values [2^n, 9] and f, xf [N, n, 9], got {tuple(values.shape)}, "
            f"{tuple(f.shape)}, {tuple(xf.shape)}"
        )
    if n > _RING_FOLD_MAXN:
        raise ValueError(f"ring_fold takes at most {_RING_FOLD_MAXN} factors a row, got {n}")
    values, f, xf = values.contiguous(), f.contiguous(), xf.contiguous()
    out = torch.empty((N, NLIMBS), dtype=torch.int32, device=values.device)
    code = lib.zk_ring_fold(
        n, N, values.data_ptr(), f.data_ptr(), xf.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    _build.check(code, "zk_ring_fold")
    ring_fold.launches += 1
    return out


ring_fold.launches = 0


def field_sum_plain(f: FieldT, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`field_sum`, on any device: a
    tree of ``FieldT.add`` calls that halves the leading axis each step
    (modular addition is exact, so the order does not change the
    integers)."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=torch.int32, device=x.device)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = torch.cat([f.add(x[:h], x[h : 2 * h]), x[2 * h :]])
    return x[0].clone()


def field_sum(f: FieldT, x: torch.Tensor) -> torch.Tensor:
    """sum_d x[d] mod p: canonical [D, R, 9] limbs -> [R, 9] canonical.

    Kernel ``csrc/field.cu`` (replaces the ``fo.add`` folds of
    ``zkecdsa_tpu/parallel/mesh.py:130-136``, ``:204-207`` and
    ``:255-258``, which sum the ring-sharded GK partials): a thread a row
    for up to SUM_ROW_MAX_D terms, else a block a row with a shuffle tree
    (:func:`field_plan`); bound by the bytes it reads.  A CPU tensor takes
    :func:`field_sum_plain`."""
    if x.device.type == "cpu":
        return field_sum_plain(f, x)
    lib = _build.load()
    _check_limbs(x)
    if x.dim() != 3:
        raise ValueError(f"expected [D, R, {NLIMBS}] limbs, got {tuple(x.shape)}")
    x = x.contiguous()
    D, R = x.shape[0], x.shape[1]
    plan = field_plan(R, _sms(x.device), D)
    out = torch.empty((R, NLIMBS), dtype=torch.int32, device=x.device)
    code = lib.zk_field_sum(
        f.mod_id, D, R, x.data_ptr(), out.data_ptr(), plan.lanes, plan.threads,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(code, "zk_field_sum")
    field_sum.launches += 1
    return out


field_sum.launches = 0
