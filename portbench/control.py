"""The control of the comparison: the plain reference put in the
program's place and computed in bfloat16, the precision below the float32
the configurations state.  It has to come out as not correct.

    python3 -m portbench.control --workload <name> --seeds 11,12,13 [--steps 100]

For each seed it makes the cell's inputs as a run does, draws the run's
number of sampled queries from ``--steps`` window steps, answers them with
the reference in bfloat16 (scores, sums and the top-k by its own scores),
and prints the comparison's readings against the float64 reference as
one JSON line.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import manifest
from .check import compare
from .corpus import CorpusModel, derive_seed, generator, make_corpus, make_postings
from .queries import make_queries
from .harness import answer_sample, make_reference
from .reference.bm25 import top_lists
from .writes import Writes

__all__ = ["control_readings", "main"]


def control_readings(cell: manifest.Cell, seed: int, steps: int, device, dtype=torch.bfloat16) -> dict:
    """The readings of the reference in ``dtype`` in the program's place."""
    dev = torch.device(device)
    cfg, mix, cc = cell.config, cell.traffic, cell.cell
    batch, k, warm = int(mix["batch"]), int(mix["k"]), int(mix["warmup_batches"])
    model = CorpusModel.from_config(cfg)
    corpus = make_corpus(model, seed, dev)
    n_steps = warm + steps
    q_start, q_tid = make_queries(corpus, n_steps * batch, mix["queries"], seed, dev)
    writes, extra = None, None
    if mix.get("writes"):
        writes = Writes.from_spec(mix["writes"], model.n_docs, n_steps, seed)
        ex = make_postings(model, writes.n_extra, generator(seed, "inserts", dev), dev)
        extra = (ex.start.cpu().numpy(), ex.tid.cpu().numpy(), ex.tf.cpu().numpy())
        writes.preload_docs()
        for s in range(n_steps):
            writes.step(s)
    corpus.by_doc = corpus.df = None
    rng = np.random.default_rng(derive_seed(seed, "control"))
    take = int(cc["check_queries"])
    flat = rng.choice(steps * batch, size=min(take, steps * batch), replace=False)
    chosen = sorted((warm + int(f) // batch, int(f) % batch) for f in flat)
    ref = make_reference(cell, corpus, extra, dev)
    low = make_reference(cell, corpus, extra, dev, dtype)

    def answer(part, words, visible, deleted):
        lists = top_lists(low.sums(words, visible, deleted), k)
        return [list(zip(s.tolist(), c.tolist())) for s, c in lists]

    t0 = time.perf_counter()
    got, want, wog = answer_sample(ref, chosen, q_start, q_tid, batch, k, writes, answer)
    limit = float(cc["limits"]["score_rel_err"])
    r = compare(got, want, wog, limit)
    return {
        "workload": cell.name,
        "seed": seed,
        "dtype": str(dtype).replace("torch.", ""),
        "queries": r.queries,
        **r.values(),
        "limits": cc["limits"],
        "correct": all(r.values()[n] <= cc["limits"][n] for n in cc["limits"]),
        "reference_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--steps", type=int, default=100)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load_cell(manifest.load_benchmark(os.getcwd()), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(cell, seed, args.steps, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
