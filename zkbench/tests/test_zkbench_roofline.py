"""The frozen roofline table (``zkbench/roofline``): its constants are the
ones ``chip_smoke.py`` derived at the parent commit, and at
``chip_smoke.py``'s phase-3 shapes each kernel's least time is the bound
``PERF.md`` records for the kernels (ms, to the digits printed there)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench.roofline import model  # noqa: E402


def test_frozen_constants():
    assert model.HBM_BYTES_PER_S == 3.35e12
    assert model.IMAD_PER_S == 16.75e12 == 67e12 / 2 / 2
    assert model.IMAD_PER_PRODUCT == {"montgomery": 342, "solinas_p256": 128}
    assert (model.MM_WEIER_ADD, model.MM_WEIER_DBL) == (14, 13)
    assert (model.MM_EDW_ADD, model.MM_EDW_DBL, model.MM_EDW_MIXED) == (11, 9, 9)
    assert model.PRIMES["p256.p"] == 2**256 - 2**224 + 2**192 + 2**96 - 1


# (kind, curve, sizes, PERF.md's bound ms as printed, bound by)
RECORDED = [
    ("ec_add", "p256", dict(B=256 * 20), "0.0015", "operations"),
    ("window_table", "p256", dict(B=256), "0.0010", "operations"),
    ("to_affine", "p256", dict(B=256 * 20 * 2), "0.0011", "operations"),
    ("comb_mixed", "tom256", dict(B=256 * 20 * 2), "0.120", "operations"),
    ("shamir", "p256", dict(R=256, tables=2), "0.0268", "operations"),
    ("comb4_bases", "p256", dict(B=256), "0.0171", "operations"),
    ("comb4_entries", "p256", dict(B=256), "0.0786", "operations"),
    ("mul_comb4", "p256", dict(B=256, E=80), "0.375", "operations"),
    ("comb_weier", "p256", dict(rows=256 * 81), "0.190", "operations"),
    ("chord", "p256", dict(K=10240), "0.0052", "operations"),
    ("ring_fold", "p256", dict(M=256, n=12, RING=4096), "0.0428", "operations"),
    ("ring_fold", "p256", dict(M=3072, n=12, RING=4096), "0.514", "operations"),
    ("straus_msm", "p256", dict(R=5376, T=1, terms=5376, rows=5376), "0.485", "operations"),
    ("tree_sum", "tom256", dict(n=16, M=16), "5.4e-05", "operations"),
    ("to_affine", "p256", dict(B=256 * 163), "0.00427", "operations"),
    ("to_affine", "tom256", dict(B=256 * 162), "0.00424", "operations"),
    ("to_affine", "tom256", dict(B=10240 * 39), "0.0408", "operations"),
    ("to_affine", "tom256", dict(B=12288), "0.00126", "operations"),
    ("comb_mixed", "tom256", dict(B=256 * 162), "0.488", "operations"),
    ("comb_mixed", "tom256", dict(B=10240 * 34), "4.095", "operations"),
    ("comb_mixed", "tom256", dict(B=12288), "0.1445", "operations"),
    ("ec_add", "tom256", dict(B=10240 * 5), "0.0115", "operations"),
]


@pytest.mark.parametrize("kind,curve,sizes,printed,by", RECORDED, ids=[f"{r[0]}-{r[3]}" for r in RECORDED])
def test_recorded_bounds(kind, curve, sizes, printed, by):
    """The work counted is ``chip_smoke.py``'s: priced as it priced these
    kernels (Montgomery, 342 IMADs a product), it gives the bound printed."""
    products, nbytes = model.work(kind, curve, **sizes)
    t_ops = products * model.IMAD_PER_PRODUCT["montgomery"] / model.IMAD_PER_S
    t = max(t_ops, nbytes / model.HBM_BYTES_PER_S)
    digits = printed.split("e")[0].split(".")[1] if "." in printed else ""
    exp = int(printed.split("e")[1]) if "e" in printed else 0
    half_ulp = 0.5 * 10.0 ** (exp - len(digits))
    assert abs(t * 1e3 - float(printed)) <= half_ulp * 1.0001, (t * 1e3, printed)
    assert ("operations" if t_ops >= nbytes / model.HBM_BYTES_PER_S else "bytes") == by


@pytest.mark.parametrize("kind,curve,sizes,printed,by", RECORDED, ids=[f"{r[0]}-{r[3]}" for r in RECORDED])
def test_each_product_is_priced_by_its_modulus(kind, curve, sizes, printed, by):
    """One IMAD cost a modulus, whatever the kernel: Solinas (128) for
    every product mod the P-256 prime, Montgomery (342) for the Tom-256
    prime's."""
    products, nbytes = model.work(kind, curve, **sizes)
    per = {"p256": 128, "tom256": 342}[curve]
    assert model.imad_per_product(curve) == per
    t, got_by = model.least_seconds(kind, curve, **sizes)
    t_ops, t_bytes = products * per / model.IMAD_PER_S, nbytes / model.HBM_BYTES_PER_S
    assert t == max(t_ops, t_bytes)
    assert got_by == ("operations" if t_ops >= t_bytes else "bytes")


def test_the_moduli_priced():
    assert model.MODULUS == {"p256": "p256.p", "tom256": "tom.p"}
    assert model.PRICING == {"p256.p": "solinas_p256", "tom.p": "montgomery"}


def test_field_mul_on_the_p256_prime_is_priced_as_solinas():
    # PERF.md: field_mul [65536] on the P-256 prime is bound by its bytes, 0.0021 ms
    t, by = model.least_seconds("field_mul", "p256", B=65536)
    assert by == "bytes" and round(t * 1e3, 4) == 0.0021


def test_path_tables_evaluate():
    prove = model.table_rows(model.load_table("prove"), dict(N=256, RING=4096, n=12, K=10240, E=80))
    assert len(prove) == 22
    assert 5.2e-3 < model.batch_least_seconds("prove", dict(N=256, RING=4096, n=12, K=10240, E=80)) < 5.35e-3
    rows = model.table_rows(model.load_table("verify"), dict(N=256, RING=4096, n=12, S=20))
    assert any("combined" in r[0] for r in rows)  # 256 proofs fill the combined check
    rows16 = model.table_rows(model.load_table("verify"), dict(N=16, RING=4096, n=12, S=20))
    assert not any("combined" in r[0] for r in rows16)  # 16 take the per-row checks
    with pytest.raises(ValueError):
        model.evaluate("__import__('os')", {})
