"""Host synchronisations with the card per train micro-step: the
program's ``syncs`` counts summed over its ``train.step`` spans, over their
number."""

from perfbench.spans import recorded

LAYER = "train step (train/steps.py, losses/, train/optim.py)"
UNIT = "syncs"
SOURCE = "program_counter"
MOVES = "train_samples_per_s"


def read(rec):
    steps = recorded(rec, "train.step")
    if not steps:
        return None
    return sum(s["counts"].get("syncs", 0) for s in steps) / len(steps)
