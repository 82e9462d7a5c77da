"""The control and the planted faults of each cell's check, and the chip
run that reads them at the cell's own size.

    python3 -m portbench.control --workload mslr.train --seeds 1,2,3 \\
        --faulted-seeds 1,2,3 [--out FILE]

For every seed, the sound program's numbers; for the faulted seeds also
those of the control and of each fault.  One process reuses a seed's
table (training) or pool and model (serving) for every variant.  Each
line of output is one JSON record: workload, seed, variant, numbers.

- Control, training: the program with its own lower-precision path,
  ``hist_dtype=bfloat16`` (the configuration states float32).
- Control, serving: the engine's own ``quantize=int8`` leaf table (the
  configuration serves float32).
- Faults, training: ``half_batch`` (gradient and hessian of every second
  row zeroed, so the trees see half the rows), ``leaf_altered`` (each
  tree's first leaf value raised by a tenth where the grower returns
  it), ``state_unchanged`` (``train_one_iter`` returns without a tree);
  each planted from set-up on, or with ``.window`` after its name only
  in the iterations after set-up (``window_fault``).
- Faults, serving: ``half_batch`` (every second row of each engine call
  scores 0), ``answer_altered`` (the first row of each engine call
  raised by a tenth of its magnitude and 0.01).

The benchmark's own runs run none of this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

from . import run as harness
from . import serve, train


class Bf16(train.Program):
    def params(self, params):
        return dict(params, hist_dtype="bfloat16")


class Int8(serve.Program):
    def options(self, options):
        return dict(options, quantize="int8")


@contextlib.contextmanager
def patched(obj, name, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _half_grad(orig):
    def get_gradients(self, score):
        g, h = orig(self, score)
        keep = (np.arange(g.shape[-1]) % 2 == 0)
        import torch
        m = torch.as_tensor(keep, device=g.device)
        return g * m, h * m
    return get_gradients


def _altered_grow(orig):
    def _grow(self, *a, **k):
        t = orig(self, *a, **k)
        lv = np.array(t.leaf_value, copy=True)
        lv[0] = lv[0] * 1.1 + 0.01
        return t._replace(leaf_value=lv)
    return _grow


def _unchanged(orig):
    def train_one_iter(self, is_eval=True):
        return False
    return train_one_iter


def train_fault(name: str):
    """A context in which the program runs with fault ``name``."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.objectives import binary, rank
    if name == "half_batch":
        stack = contextlib.ExitStack()
        stack.enter_context(patched(binary.BinaryLogloss, "get_gradients",
                                    _half_grad))
        stack.enter_context(patched(rank.LambdarankNDCG, "get_gradients",
                                    _half_grad))
        return stack
    if name == "leaf_altered":
        return patched(GBDT, "_grow", _altered_grow)
    if name == "state_unchanged":
        return patched(GBDT, "train_one_iter", _unchanged)
    raise KeyError(name)


@contextlib.contextmanager
def window_fault(name: str):
    """Fault ``name`` switched on only once set-up has ended: in the
    window's own iterations, traced or not."""
    def wrap(orig):
        def loop(*a, **k):
            with train_fault(name):
                return orig(*a, **k)
        return loop
    with patched(train, "window", wrap), patched(train, "traced", wrap):
        yield


def _half_scores(orig):
    def scores(self, features):
        out = orig(self, features)
        out = np.array(out, copy=True)
        out[:, 1::2] = 0.0
        return out
    return scores


def _altered_scores(orig):
    def scores(self, features):
        out = np.array(orig(self, features), copy=True)
        out[:, 0] = out[:, 0] * 1.1 + 0.01
        return out
    return scores


def serve_fault(name: str):
    from lightgbm_tpu_torch.serving import ServingEngine
    if name == "half_batch":
        return patched(ServingEngine, "scores", _half_scores)
    if name == "answer_altered":
        return patched(ServingEngine, "scores", _altered_scores)
    raise KeyError(name)


TRAIN_FAULTS = ("half_batch", "leaf_altered", "state_unchanged")
SERVE_FAULTS = ("half_batch", "answer_altered")


def train_readings(cfg, traffic, seed, device, faulted: bool,
                   extra_iters: int = 2, faults=TRAIN_FAULTS):
    """[(variant, numbers)] of one seed, on one binned table: set-up,
    then ``extra_iters`` iterations whose first and last the check
    replays, as a window's."""
    prep = train.prepare(cfg, seed)
    variants = [("program", train.Program(), None)]
    if faulted:
        variants.append(("control_bf16", Bf16(), None))
        variants += [(f, train.Program(), f) for f in faults]
    out = []
    for name, program, fault in variants:
        p = dict(prep, params=program.params(dict(prep["params"])))
        whole, late = contextlib.nullcontext(), contextlib.nullcontext()
        if fault and fault.endswith(".window"):
            late = train_fault(fault[:-len(".window")])
        elif fault:
            whole = train_fault(fault)
        with whole:
            st = train.start(p, traffic, device)
            with late:
                kept = train.Kept(st["booster"])
                for _ in range(extra_iters):
                    kept.mark()
                    st["stops"] += bool(st["booster"].train_one_iter(
                        is_eval=False))
            st["points"] += kept.points()
            st["iterations"] += extra_iters
        kept = train.release(st)
        out.append((name, train.check(st, kept, cfg, traffic)))
    return out


def serve_readings(cfg, traffic, seed, device, faulted: bool,
                   seconds: float, faults=SERVE_FAULTS):
    variants = [("program", serve.Program(), None)]
    if faulted:
        variants.append(("control_int8", Int8(), None))
        variants += [(f, serve.Program(), f) for f in faults]
    out = []
    for name, program, fault in variants:
        ctx = serve_fault(fault) if fault else contextlib.nullcontext()
        with ctx:
            st = serve.setup(cfg, traffic, seed, device, program)
            records, _, _ = serve.window(st, seconds)
            serve.release(st)
        out.append((name, serve.check(st, records, seed, traffic, device)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faulted-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", default=",".join(TRAIN_FAULTS),
                    help="training faults to plant, NAME or NAME.window "
                         "(state_unchanged reads its iterations and needs "
                         "no chip run)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell, cfg, traffic, limits, _, _ = harness.resolve(bench, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    faulted = {int(s) for s in args.faulted_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for seed in seeds:
        if traffic["kind"] == "train":
            rows = train_readings(cfg, traffic, seed, args.device,
                                  seed in faulted,
                                  faults=[f for f in args.faults.split(",")
                                          if f])
        else:
            rows = serve_readings(cfg, traffic, seed, args.device,
                                  seed in faulted, args.seconds)
        for variant, numbers in rows:
            rec = json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "numbers": numbers})
            print(rec)
            sys.stdout.flush()
            if sink:
                sink.write(rec + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
