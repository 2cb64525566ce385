"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against their
plain versions, and the trainer's path through them. They import torch and
the port only (no jax), so they run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card each skips, deciding inside the test."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import quantize as Q
from repro_torch.kernels.ref import quantize_ef_ref


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(seed, rows, cols, dev):
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        0.3 * rs.randn(rows, cols), 0.05 * rs.randn(rows, cols),
        rs.rand(rows, cols)))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,levels", [(648, 1024, 127),
                                              (512, 1024, 127),
                                              (37, 1024, 7), (64, 128, 1),
                                              (16, 12288, 127)])
def test_quantize_ef_kernel_matches_plain_version(rows, cols, levels):
    """Same arithmetic in the same order: scale bit-equal, codes equal but
    for rounding-boundary flips (at most 1e-5), e' bit-equal where the
    codes agree."""
    dev = _device()
    g, e, r = _operands(rows, rows, cols, dev)
    before = Q.launches
    ck, sk, ek = Q.quantize_ef_blocked(g, e, r, levels=levels,
                                       block_rows=rows)
    assert Q.launches == before + 1
    cp, sp, ep = quantize_ef_ref(g, e, r, levels)
    assert torch.equal(sk, sp)
    same = ck == cp
    assert (~same).float().mean().item() <= 1e-5
    assert torch.equal(ek[same], ep[same])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,levels", [(2592, 1024, 127),
                                              (2048, 1024, 7), (37, 1024, 1),
                                              (16, 12288, 7)])
def test_quantize_ef_dyn_kernel_matches_plain_version(rows, cols, levels):
    """B2 (levels read from device memory): the same checks as B1, and the
    same codes, scale and residual as B1 at the same level count."""
    dev = _device()
    g, e, r = _operands(rows + 1, rows, cols, dev)
    lv = torch.full((1,), float(levels), device=dev)
    before = (Q.launches, Q.launches_dyn)
    ck, sk, ek = Q.quantize_ef_blocked(g, e, r, levels=lv, block_rows=rows)
    assert (Q.launches, Q.launches_dyn) == (before[0], before[1] + 1)
    cp, sp, ep = quantize_ef_ref(g, e, r, lv)
    assert torch.equal(sk, sp)
    same = ck == cp
    assert (~same).float().mean().item() <= 1e-5
    assert torch.equal(ek[same], ep[same])
    cb, sb, eb = Q.quantize_ef_blocked(g, e, r, levels=levels,
                                       block_rows=rows)
    assert torch.equal(cb, ck) and torch.equal(sb, sk) and torch.equal(eb, ek)


@pytest.mark.cuda
def test_quantize_ef_kernel_refuses_what_it_does_not_take():
    dev = _device()
    g, e, r = _operands(0, 8, 1024, dev)
    with pytest.raises(TypeError):
        Q.quantize_ef_blocked(g.double(), e, r)
    with pytest.raises(ValueError):
        Q.quantize_ef_blocked(g, e.cpu(), r)
    with pytest.raises(ValueError):
        Q.quantize_ef_blocked(g, e, r.t().contiguous().t())
    with pytest.raises(ValueError, match="levels is on"):
        Q.quantize_ef_blocked(g, e, r, levels=torch.tensor([127.0]))
    with pytest.raises(ValueError, match="one element"):
        Q.quantize_ef_blocked(g, e, r,
                              levels=torch.full((2,), 7.0, device=dev))


@pytest.mark.cuda
def test_trainer_step_goes_through_the_kernel():
    """dcgan32 bucketed qsgd8_block1024: 3 launches a step."""
    dev = _device()
    from repro_torch.configs import DQConfig, get
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.data import procedural_images
    from repro_torch.models import gan
    from repro_torch.strategy import Compression, Strategy

    cfg = get("dcgan32")
    strat = Strategy(compression=Compression(compressor="qsgd8_block1024",
                                             plan="uniform"))
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg),
               dq=DQConfig.from_strategy(strat, optimizer="omd", lr=1e-4),
               device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tr.init(gan.init(cfg, generator=gen, device=dev))
    before = Q.launches
    for _ in range(2):
        batch = {"real": procedural_images(8, 32, 3, generator=gen,
                                           device=dev)}
        out = tr.step(state, batch)
        state = out.state
    assert Q.launches == before + 6
    assert torch.isfinite(out.metrics["loss"]).item()


@pytest.mark.cuda
def test_four_worker_adaptive_step_goes_through_b2():
    """dcgan32, 4 stacked workers, half of them reporting, adaptive
    delta_budget: one B2 launch per bucket a step, no B1."""
    dev = _device()
    from repro_torch.configs import DQConfig, get
    from repro_torch.core.dqgan import DQGAN
    from repro_torch.data import procedural_images
    from repro_torch.models import gan
    from repro_torch.strategy import (Compression, ExchangePlan,
                                      Participation, Strategy)

    cfg = get("dcgan32")
    strat = Strategy(
        compression=Compression(compressor="qsgd8_block1024",
                                plan="delta_budget", budget_mb=0.75,
                                adaptive=True),
        exchange=ExchangePlan(kind="sim", worker_axes=("data",)),
        participation=Participation(fraction=0.5))
    tr = DQGAN(field_fn=gan.gan_field_fn(cfg),
               dq=DQConfig.from_strategy(strat, optimizer="omd", lr=1e-4),
               device=dev, workers=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tr.init(gan.init(cfg, generator=gen, device=dev))
    before = (Q.launches, Q.launches_dyn)
    for _ in range(2):
        batch = {"real": procedural_images(16, 32, 3, generator=gen,
                                           device=dev)}
        out = tr.step(state, batch)
        state = out.state
    assert (Q.launches, Q.launches_dyn) == (before[0], before[1] + 6)
    assert torch.isfinite(out.metrics["loss"]).item()
