"""Flip fractions of whisper-tiny (reduced) against the JAX package on
the model axis: the share of e1 residual elements that differ by more
than 1e-3 of the largest (`repro_torch.parity`'s count), for the port at
model 1 (two workers stacked) against JAX on a (2, 1) mesh and at model
2 (four gloo ranks) against JAX on (2, 2), each on its JAX run's draws,
with `qsgd8_block1024` buckets and with `qsgd8_linf` per tensor, for
each draw seed given (the test's own is 7). One JSON line per seed,
case and pair, with the leaves that flipped most.

    PYTHONPATH=src python tests/model_axis_flips.py 7 11 13 17
"""
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_model_axis as M  # noqa: E402
from repro_torch.parity import _flipped  # noqa: E402

CASES = {"buckets": ("whisper-tiny", M.BUCKETS, "sim"),
         "linf": ("whisper-tiny", M.LINF, "sim")}


def _jax_run(seed, out, model):
    """The test's JAX script on a (2, model) mesh, its draw key and its
    batches from `seed`."""
    from conftest import run_multidevice
    cases = {n: (arch, M._jax_strategy(comp, kind))
             for n, (arch, comp, kind) in CASES.items()}
    script = M.SCRIPT % dict(W=M.W, STEPS=M.STEPS, B=M.B, S=M.S,
                             cases=json.dumps(cases), out=out)
    for a, b in (("make_mesh((2, 2),", f"make_mesh((2, {model}),"),
                 ("KEY = jax.random.key(7)",
                  f"KEY = jax.random.key({seed})"),
                 ("jax.random.key(1), t)",
                  f"jax.random.key({seed + 100}), t)")):
        assert a in script, a
        script = script.replace(a, b)
    assert "OK" in run_multidevice(script, n_devices=2 * model, timeout=900)
    return dict(np.load(f"{out}/runs.npz"))


def _rank(mesh, data):
    M.CASES.clear()
    M.CASES.update(CASES)
    torch.set_num_threads(1)
    out = {}
    for name in CASES:
        tr, st, _ = M._train(mesh, name, data)
        out[name] = M._global(tr, st)
    return out if mesh.rank == 0 else None


def _flips(ref, got):
    e1 = [k for k in ref if k.startswith("ef/") and k.endswith("/e1")]
    re = [torch.from_numpy(np.asarray(ref[k], np.float32)) for k in e1]
    ge = [torch.from_numpy(np.asarray(got[k], np.float32)) for k in e1]
    t = 1e-3 * max(e.abs().max().item() for e in re)
    per = {k: int(((a - b).abs() > t).sum()) for k, a, b in zip(e1, re, ge)}
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:3])
    return _flipped(re, ge, [t] * len(re)), top


def main():
    from torch_ranks import run_ranks
    M.CASES.clear()
    M.CASES.update(CASES)
    torch.set_num_threads(1)
    for seed in [int(a) for a in sys.argv[1:]] or [7]:
        with tempfile.TemporaryDirectory() as tmp:
            for m in (1, 2):
                os.makedirs(f"{tmp}/{m}")
            one = _jax_run(seed, f"{tmp}/1", 1)
            two = _jax_run(seed, f"{tmp}/2", 2)
            port2 = run_ranks(_rank, 4, two, model=2, timeout=600)[0]
            for name in CASES:
                port1 = M._named(M._train(None, name, one)[1])
                for pair, m, got in (("model 1", 1, port1),
                                     ("model 2", 2, port2[name])):
                    ref = M._named_npz(f"{tmp}/{m}/{name}_jax.npz")
                    frac, top = _flips(ref, got)
                    print(json.dumps(dict(seed=seed, case=name, pair=pair,
                                          flipped=frac, top=top)),
                          flush=True)


if __name__ == "__main__":
    main()
