"""`correct` comes out false where it should.

The control: the reference computed with float8 e4m3 operands in every
linear layer, put in the program's place, against the float32 reference.
On the card (marked `cuda`) at the cell's own size, judged under the
cell's limits, which were set for that size; on the CPU at a tiny size in
bfloat16, where it must read the gradient's sketch several times farther
from the reference than the program does.

The faults: a run of a tiny cell with the timed path broken underneath
(the step returning its state unchanged; half of each batch left out,
the mean taken over the rest), which must read not correct, where the
same run unbroken reads correct."""
import json
import time

import pytest
import torch

from bench import cell, correct, spec
from bench.tests.tiny import ROOT, SIZES, make_root

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"] if w["chips"] == 1]


def _numbers(plan, seed, device):
    """(the program's numbers, the control's), each against the float32
    reference of the same seed."""
    trainer, state, batches, prog = cell.program_steps(
        plan, seed, False, device, log=lambda s: None)
    del trainer, state
    cell.free(device)
    ref = cell.reference_readings(plan, seed, batches, device)
    ctl = cell.reference_readings(plan, seed, batches, device,
                                  compute="fp8")
    return correct.numbers(prog, ref), correct.numbers(ctl, ref)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_reads_far_at_a_tiny_size(tmp_path, name):
    cells = make_root(tmp_path, dtype="bfloat16")
    plan = cell.Plan(spec.load_cell(cells[name], tmp_path))
    prog, ctl = _numbers(plan, 2 ** 31 + 901, torch.device("cpu"))
    assert ctl["grad_sketch_rms"] >= 3 * prog["grad_sketch_rms"], (prog,
                                                                   ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    plan = cell.Plan(spec.load_cell(name, ROOT))
    prog, ctl = _numbers(plan, 2 ** 31 + 902, torch.device("cuda:0"))
    assert correct.judge(prog, plan.cell.limits)[0]
    ok_ctl, checks = correct.judge(ctl, plan.cell.limits)
    assert not ok_ctl, checks


def _run(root, name):
    c = spec.load_cell(name, root)
    res, _ = cell.run(c, 2 ** 31 + 33, 0.2, False, "cpu",
                      time.perf_counter(), log=lambda s: None)
    return res


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("faults")
    return d, make_root(d, dtype="float32")


@pytest.mark.parametrize("name", sorted(SIZES))
def test_sound_run_reads_correct(root, name):
    d, cells = root
    assert _run(d, cells[name])["correct"] is True


@pytest.mark.parametrize("name", sorted(SIZES))
def test_state_left_unchanged_reads_incorrect(root, name, monkeypatch):
    from repro_torch.core import dqgan
    real = dqgan.DQGAN.step

    def step(self, state, batch, *a, **kw):
        out = real(self, state, batch, *a, **kw)
        return out._replace(state=state)

    monkeypatch.setattr(dqgan.DQGAN, "step", step)
    d, cells = root
    res = _run(d, cells[name])
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_half_batch_reads_incorrect(root, name, monkeypatch):
    from repro_torch.models import registry
    real = registry.lm_field_fn

    def lm_field_fn(cfg):
        field = real(cfg)

        def half(params, batch, z=None, generator=None):
            n = batch["tokens"].shape[0] // 2
            return field(params, {k: v[:n] for k, v in batch.items()}, z,
                         generator)
        return half

    monkeypatch.setattr(registry, "lm_field_fn", lm_field_fn)
    d, cells = root
    res = _run(d, cells[name])
    assert res["correct"] is False, res["checks"]
