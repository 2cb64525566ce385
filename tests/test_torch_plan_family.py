"""Port parity: the round-adaptive `PlanFamily` (`repro_torch.comm.planner`)
and the ledger's per-round billing against `repro`, on dcgan32 at full
width. These are host-side integer computations: equal, not close."""
import dataclasses
import warnings

import jax
import pytest

from repro.configs import get as jget
from repro.models import gan as jgan
from repro.strategy import Compression as JComp
from repro_torch.strategy import Compression as TComp
from torch_ranks import one_thread  # noqa: F401 (autouse)

FULL = jget("dcgan32")
WORKERS = [4, 8]
BUDGETS = [0.5, 0.75, 1.0]


def _shapes():
    params = jax.eval_shape(lambda: jgan.init(jax.random.key(0), FULL))
    return jax.tree.map(lambda x: tuple(x.shape), params)


def _families(W, mb, base="qsgd8_block1024"):
    kw = dict(compressor=base, plan="delta_budget", budget_mb=mb,
              adaptive=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a floor overrun warns in both
        lj, fj = JComp(**kw).build_family(_shapes(), None, W)
        lt, ft = TComp(**kw).build_family(_shapes(), None, W)
    return (lj, fj), (lt, ft)


@pytest.mark.parametrize("W", WORKERS)
@pytest.mark.parametrize("mb", BUDGETS)
def test_family_equal(W, mb):
    (lj, fj), (lt, ft) = _families(W, mb)
    assert lt.describe() == lj.describe()
    assert ft.levels_table() == fj.levels_table()
    assert ft.bits_table() == fj.bits_table()
    assert ft.describe() == fj.describe()
    assert ft.n_distinct == fj.n_distinct
    assert (ft.n_workers, ft.budget_bytes, ft.base_compressor) == (
        fj.n_workers, fj.budget_bytes, fj.base_compressor)
    for n in range(1, W + 1):
        assert ft.effective_budget(n) == fj.effective_budget(n)
        a, b = ft.plan_for(n), fj.plan_for(n)
        assert [dataclasses.astuple(x) for x in a.assignments] == [
            dataclasses.astuple(x) for x in b.assignments]
    assert ft.full.describe() == fj.full.describe()
    with pytest.raises(ValueError):
        ft.plan_for(W + 1)


def test_dcgan32_four_workers_mixes_bit_widths():
    """The configuration the card runs: 4 distinct members; two of four
    workers select (7, 127, 127) levels, the full plan (1, 7, 7)."""
    _, (layout, fam) = _families(4, 0.75)
    assert [b.size // 1024 for b in layout.buckets] == [648, 648, 512]
    assert fam.n_distinct == 4
    table = fam.levels_table()
    assert table[1] == (7, 127, 127) and table[3] == (1, 7, 7)


def test_family_diff_names_the_member():
    (_, fj), (_, ft) = _families(4, 0.75)
    (_, fj2), (_, ft2) = _families(4, 1.0)
    assert ft.diff(ft2) == fj.diff(fj2)
    assert ft.diff(ft2) and ft.diff(ft) == []


@pytest.mark.parametrize("W", WORKERS)
@pytest.mark.parametrize("mb", BUDGETS)
@pytest.mark.parametrize("kind", ["sim", "allgather", "two_phase"])
def test_ledger_round_billing_equal(W, mb, kind):
    from repro.comm import CommLedger as JL
    from repro_torch.comm import CommLedger as TL
    (lj, fj), (lt, ft) = _families(W, mb)
    base = "qsgd8_block1024"
    gj = JL.from_plan(lj, fj.full, kind, W, base, family=fj)
    gt = TL.from_plan(lt, ft.full, kind, W, base, family=ft)
    for n in range(1, W + 1):
        assert gt.round_bytes(n) == gj.round_bytes(n)
        assert gt.effective_budget(n) == gj.effective_budget(n)
        assert gt.per_bucket(n) == gj.per_bucket(n)
    assert gt.round_bytes(None) == gj.round_bytes(None)
    n_part = W // 2
    for parts in (n_part, n_part, None, W, 1):
        gj.tick(participants=parts)
        gt.tick(participants=parts)
        assert gt.summary() == gj.summary()
    assert gt.last_participants == gj.last_participants == 1
    assert "participants" in gt.summary()
